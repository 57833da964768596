// The one-thread-a-column WKV6 kernel that csrc/wkv6.cu replaced (git
// 783a96d), kept unchanged below this note as tools/k7_variants.py's
// baseline: that tool builds it as a library of its own beside the
// variants of csrc/wkv6.cu. The package never builds or loads it.
//
// WKV6 recurrence (RWKV-6 "Finch" time-mix core) for Hopper (sm_90a),
// plain C interface. Per (batch, head), over S steps from the state S_0 (or
// zeros), with the state laid out [k][v]:
//   kv  = k_t v_t^T
//   y_t = r_t^T (S + diag(u) kv)
//   S   = diag(w_t) S + kv
// and the final state. r, k, v, w are [B, S, H, 64] f32 (w the decay in
// (0, 1)), u [H, 64] f32, the states [B, H, 64, 64] f32.
//
// Replaces no Pallas kernel: the reference computes this recurrence as a
// lax.scan (repro/models/ssm.py::_rwkv6_core), one step a loop iteration,
// and leaves a faster formulation to the kernel layer. On the card that
// scan in plain PyTorch costs six launches a token a layer; this kernel
// (K7) runs the whole sequence in one launch.
//
// Layout: one block of 64 threads per (batch, head); thread j keeps column
// j of the head's state (S[i][j], i = 0..63) in 64 registers for the whole
// sequence. Each step the threads stage r_t, k_t and w_t (one element
// each) in shared memory, double-buffered so that one barrier a step
// suffices, and thread j reads v_t[j] itself; u is staged once. The next
// step's four elements are loaded into registers before the current step's
// arithmetic, so their latency hides behind it. Per (i, j) and step, in the
// reference's rounding order, each product and sum rounded (explicit
// intrinsics, so that the compiler contracts nothing and a step computes
// the same bits whether it is one launch's first or a longer launch's
// t-th: S launches at S = 1, chained through the state, equal one launch
// over S bit for bit):
//   kv = k_i v_j;  acc += r_i (S_ij + u_i kv);  S_ij = fma(w_i, S_ij, kv)
// y_j sums over i in four partial sums (i mod 4), added pairwise at the
// end, which cuts the dependent chain of 64 FMAs to 16.
//
// What bounds it on an H100: at a full-width prefill (B=4, S=2048, H=40)
// 425 MB of r, k, v, w, y and the states (0.13 ms at 3.35 TB/s) against
// the operations the function needs: 5 f32 operations per state element
// and step (w S + k v, then y += r S) and the rank-one bonus
// v_j sum_i r_i u_i k_i, 3 per head element and step (6.7 GFLOP at
// 67 TFLOP/s, 0.10 ms); chip_smoke.py computes and reports the bound. This design
// runs 160 blocks of two warps on 132 SMs: the issue rate of one or two
// warps an SM sub-partition and the barrier a step bind it, not the card's
// peaks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;  // head size, one thread per state column
constexpr int NA = 4;   // partial sums of y_j

struct Args {
  const float* r;     // [B, S, H, HD]
  const float* k;
  const float* v;
  const float* w;
  const float* u;     // [H, HD]
  const float* s_in;  // [B, H, HD, HD], or null for zeros
  float* y;           // [B, S, H, HD]
  float* s_out;       // [B, H, HD, HD]
  int S, H;
};

__global__ void __launch_bounds__(HD) wkv6_kernel(const Args a) {
  __shared__ float4 sr[2][HD / 4], sk[2][HD / 4], sw[2][HD / 4];
  __shared__ float4 su[HD / 4];
  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % a.H, b = bh / a.H;
  const int j = threadIdx.x;

  float st[HD];
  const size_t s0 = (size_t)bh * HD * HD + j;
  if (a.s_in != nullptr) {
#pragma unroll
    for (int i = 0; i < HD; ++i) st[i] = a.s_in[s0 + (size_t)i * HD];
  } else {
#pragma unroll
    for (int i = 0; i < HD; ++i) st[i] = 0.0f;
  }
  reinterpret_cast<float*>(su)[j] = a.u[h * HD + j];

  const size_t step = (size_t)a.H * HD;                     // t -> t + 1
  size_t cur = ((size_t)b * a.S * a.H + h) * HD + j;        // (b, 0, h, j)
  float rn = a.r[cur], kn = a.k[cur], wn = a.w[cur], vn = a.v[cur];
  for (int t = 0; t < a.S; ++t) {
    const int buf = t & 1;
    reinterpret_cast<float*>(sr[buf])[j] = rn;
    reinterpret_cast<float*>(sk[buf])[j] = kn;
    reinterpret_cast<float*>(sw[buf])[j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < a.S) {  // the next step's elements, in flight meanwhile
      const size_t nxt = cur + step;
      rn = a.r[nxt];
      kn = a.k[nxt];
      wn = a.w[nxt];
      vn = a.v[nxt];
    }
    float acc[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int i4 = 0; i4 < HD / 4; ++i4) {
      const float4 r4 = sr[buf][i4], k4 = sk[buf][i4], w4 = sw[buf][i4];
      const float4 u4 = su[i4];
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float& s = st[4 * i4 + q];
        const float kv = __fmul_rn(kk[q], vj);
        acc[q] = __fmaf_rn(rr[q], __fadd_rn(s, __fmul_rn(uu[q], kv)), acc[q]);
        s = __fmaf_rn(ww[q], s, kv);
      }
    }
    a.y[cur] = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    cur += step;
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) a.s_out[s0 + (size_t)i * HD] = st[i];
}

}  // namespace

// y and the final state of the WKV6 recurrence over S steps (see above):
// r, k, v, w, y [B, S, H, hd]; u [H, hd]; s_in (null: zeros) and s_out
// [B, H, hd, hd], all f32 and contiguous. Takes hd = 64 and S >= 1 only. Launches on `stream`; returns cudaGetLastError() after
// the launch (0 = ok).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* y, void* s_out, int B, int S, int H, int hd,
                           void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  if (hd != HD || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Args a{static_cast<const float*>(r),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(w),
               static_cast<const float*>(u),    static_cast<const float*>(s_in),
               static_cast<float*>(y),          static_cast<float*>(s_out),
               S,                               H};
  wkv6_kernel<<<B * H, HD, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
