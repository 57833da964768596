// Streaming-softmax attention for Hopper (sm_90a), plain C interface:
// out[b, i, h] = softmax_j(q_i . k_j * scale | mask(i, j)) @ v, with the
// mask by position: causal (j <= i) and/or a sliding window (i - j < W).
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py::_flash_kernel
// (K5), the attention core of hymba's batched prefill. Its arithmetic is
// the Pallas kernel's: f32 scores and running (m, l, acc); masked scores
// set to NEG = -1e30; m clamped at -0.5e30 so a row with nothing live yet
// gives exp(...) = 0, not NaN; masked p set to 0; out = acc / max(l, 1e-30).
//
// Layout: one block of 256 threads per (b, h, 64-query tile). The block
// walks the key tiles of its band only, from max(0, q0 - W + 1) to the
// causal end (all key tiles when not causal), which is the Pallas kernel's
// early-out of fully masked tiles as a loop bound. GQA: head h reads KV
// head h / (H / KV), so the grouped k and v are never expanded in memory.
// Tiles of q, k, v (any float type in memory, f32 in shared memory, rows
// padded by one word against bank conflicts) and of p; four threads per
// query row, each holding 16 scores of a key tile and hd / 4 columns of
// acc in registers; row max and sum over the four with xor shuffles.
// Ragged S is masked. Plain f32 FMAs, no tensor cores: a simple kernel
// that is right first (tensor cores, TMA and wgmma are later work).
//
// What bounds it on an H100: operations. At hymba's prefill (B=4, S=2048,
// 25 heads of 64, window 1024) about 1.57 M live (q, k) pairs per (b, h),
// 4 x hd FLOPs each: ~40 GFLOP per layer against ~50 MB of bf16 q, k, v
// and out; chip_smoke.py computes the bound at the f32 and the bf16
// tensor-core rates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 4 per query row
constexpr int KPT = BK / 4;  // scores per thread per key tile
constexpr float NEG = -1e30f;

__host__ __device__ constexpr int smem_floats(int hd) {
  return 3 * BQ * (hd + 1) + BQ * (BK + 1);
}

// CPT = columns of acc per thread (hd / 4 rounded up to 16 or 32).
template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int KV, int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                 // [BQ][ld]
  float* Ks = Qs + BQ * ld;         // [BK][ld]
  float* Vs = Ks + BK * ld;         // [BK][ld]
  float* Ps = Vs + BK * ld;         // [BQ][BK + 1]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int r = tid / 4;      // this thread's query row in the tile
  const int g = tid % 4;      // its quarter of the keys / columns
  const int qpos = q0 + r;

  const size_t q_row = (size_t)H * hd;    // stride of one position in q
  const size_t kv_row = (size_t)KV * hd;  // ... in k and v
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * hd;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)kvh * hd;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)kvh * hd;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int rr = i / hd, dd = i % hd;
    Qs[rr * ld + dd] =
        q0 + rr < S ? to_f32(qb[(size_t)(q0 + rr) * q_row + dd]) : 0.0f;
  }

  // the band of key tiles this query tile can see
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int hi = causal ? (min(q0 + BQ, S) - 1) / BK : (S - 1) / BK;

  float m = NEG, l = 0.0f;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.0f;
  const int ncol = hd / 4;    // columns this thread owns: g + 4 * j

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int i = tid; i < BK * hd; i += NT) {
      const int rr = i / hd, dd = i % hd;
      const bool ok = k0 + rr < S;
      const size_t off = (size_t)(k0 + rr) * kv_row + dd;
      Ks[rr * ld + dd] = ok ? to_f32(kb[off]) : 0.0f;
      Vs[rr * ld + dd] = ok ? to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();

    // scores of keys g + 4 * j
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float qv = Qs[r * ld + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qv * Ks[(g + 4 * j) * ld + d];
    }
    bool live[KPT];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + g + 4 * j;
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      live[j] = ok;
      s[j] = ok ? s[j] * scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(m, mx), -0.5e30f);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = live[j] ? expf(s[j] - m_new) : 0.0f;
      sum += p;
      Ps[r * (BK + 1) + g + 4 * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the row's four threads (one warp) wrote Ps[r]

#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * (BK + 1) + kk];
      const float* vr = Vs + kk * ld + g;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (j < ncol) acc[j] += p * vr[4 * j];
    }
  }

  if (qpos < S) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * S + qpos) * q_row + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (j < ncol) o[g + 4 * j] = from_f32<T>(acc[j] * inv_l);
  }
}

template <typename T, int CPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, float scale, int causal, int window,
           cudaStream_t stream) {
  const int bytes = smem_floats(hd) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + BQ - 1) / BQ;
  flash_kernel<T, CPT><<<B * H * n_qt, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, hd, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 = ok).
// q, out [B, S, H, hd]; k, v [B, S, KV, hd], contiguous, all f32 (bf16 =
// 0) or all bf16 (bf16 = 1); H % KV == 0; hd % 4 == 0 and hd <= 128 (the
// wrapper checks); window <= 0 means none. Nothing is allocated here.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      int window, int bf16, float scale,
                                      void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 4 != 0 || hd > 128 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (hd <= 64)
      return launch<__nv_bfloat16, 16>(q, k, v, out, B, S, H, KV, hd, scale,
                                       causal, window, s);
    return launch<__nv_bfloat16, 32>(q, k, v, out, B, S, H, KV, hd, scale,
                                     causal, window, s);
  }
  if (hd <= 64)
    return launch<float, 16>(q, k, v, out, B, S, H, KV, hd, scale, causal,
                             window, s);
  return launch<float, 32>(q, k, v, out, B, S, H, KV, hd, scale, causal,
                           window, s);
}
