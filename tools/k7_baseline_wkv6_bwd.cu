// The first hand-written K7 backward that csrc/wkv6_bwd.cu replaced (git
// 44a0ee3), kept unchanged below this note as tools/k7_bwd_variants.py's
// baseline: that tool builds it as a library of its own beside the
// variants of csrc/wkv6_bwd.cu. The package never builds or loads it.
//
// The backward of the WKV6 recurrence (K7, csrc/wkv6.cu) for Hopper
// (sm_90a), plain C interface. Per (batch, head), with the state laid out
// [k][v] (row i, column j), the forward over S steps from S_0 is
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} +
//   k_t v_t^T.
// Given dy_t and dS_S (the final state's cotangent, or zeros), with
// a_t = sum_i r_i u_i k_i and vdy_t = v_t . dy_t, it walks t = S .. 1:
//   dv_t[j] = sum_i dS_t[i,j] k_i + a_t dy_j
//   dk_t[i] = sum_j dS_t[i,j] v_j + r_i u_i vdy_t
//   dr_t[i] = sum_j S_{t-1}[i,j] dy_j + u_i k_i vdy_t
//   dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//   du[i]  += r_i k_i vdy_t                  (summed over b and t)
//   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
// and returns dS_0, the initial state's gradient. Plain version:
// kernels/ref.py::wkv6_scan_bwd_ref. r, k, v, w, dy are [B, S, H, 64] f32,
// u [H, 64], the states [B, H, 64, 64].
//
// The states cannot be run backwards (w = exp(-exp(.)) can be tiny), and a
// record of every step is B H S 16 KB (5.4 GB at B = 4, S = 2048, H = 40).
// So one call makes four launches:
//  1. ckpt_kernel, a block a (batch, head): the state every C = 64 steps
//     (before each chunk of C steps), its update rounded as K7 rounds it,
//     S = fma(w, S, k v), so that each checkpoint is K7's state after the
//     same steps bit for bit; then a_t, summed in f64 and rounded to f32
//     once as K7 sums it, and vdy_t the same way.
//  2. bwd_kernel, G = 4 blocks a (batch, head), each taking 16 state rows
//     (all 64 columns): 256 threads, a thread one row and four columns. It
//     walks the chunks in reverse. Per chunk it stages the chunk's r, k, w
//     (its rows), v, dy, a_t and vdy_t in shared memory, runs the chunk
//     forward from its checkpoint keeping the state at each D = 16 steps
//     (in registers), then per sub-chunk of D steps, last first, recomputes
//     the D states into registers and walks them backwards. Each element's
//     state and gradient are independent recurrences; only the outputs
//     couple them. The row sums (dr, dk, dw) meet over the 16 lanes of a
//     row by a butterfly; dv's column sums over the block's 16 rows by a
//     shuffle, then over the 8 warps in shared memory in warp order, into
//     a partial per block (dv_part [G, B, S, H, 64]); du over t in the
//     row's own thread, into du_part [B, H, 64].
//  3. dv_kernel: dv = fma(a_t, dy, ((p_0 + p_1) + p_2) + p_3).
//  4. du_kernel: du = the sum of du_part over b, in b's order.
// No atomics: every sum has a fixed order, so two calls give the same bits.
//
// What bounds it on an H100: at B = 4, S = 2048, H = 40 the function must
// read r, k, v, w, dy and write dr, dk, dv, dw (9 x 84 MB, 0.23 ms at 3.35
// TB/s) against 14 f32 operations a state element and step (three for the
// state, k v then w S + k v; three for its gradient; two a multiply-add for
// each of the four sums) and 15 a head element and step, 19.1 GFLOP: 0.29
// ms at 67 TFLOP/s (chip_smoke.py computes and reports the bound). This
// first design recomputes the states twice (the sub-chunk starts, then
// each sub-chunk), reads the inputs again in launch 1, and writes and
// reads dv's partials; splitting columns over more blocks and staging
// chunks by cp.async ahead of use are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int HD = 64;             // head size: state rows and columns
constexpr int C = 64;              // steps between checkpoints
constexpr int D = 16;              // steps a sub-chunk, states in registers
constexpr int NSUB = C / D;        // sub-chunks a chunk
constexpr int G = 4;               // row blocks a (batch, head)
constexpr int RB = HD / G;         // rows a block
constexpr int CPT = 4;             // columns a thread
constexpr int TPR = HD / CPT;      // threads a row
constexpr int NT = RB * TPR;       // threads a block
constexpr int WARPS = NT / 32;
constexpr int CK_NT = 256;         // threads of the checkpoint kernel
constexpr int CK_CPT = HD * HD / CK_NT;  // its state elements a thread
static_assert(C % D == 0 && TPR == 16 && NT == 256 && WARPS == 8 &&
                  CK_CPT == 16,
              "layout");

struct Args {
  const float* r;     // [B, S, H, HD]
  const float* k;
  const float* v;
  const float* w;
  const float* u;     // [H, HD]
  const float* s_in;  // [B, H, HD, HD], or null for zeros
  const float* dy;    // [B, S, H, HD]
  const float* ds_T;  // [B, H, HD, HD], or null for zeros
  float* ckpt;        // [B, H, nch, HD, HD]
  float* at;          // [B, S, H]
  float* vdy;         // [B, S, H]
  float* dv_part;     // [G, B, S, H, HD]
  float* du_part;     // [B, H, HD]
  float* dr;          // [B, S, H, HD]
  float* dk;
  float* dv;
  float* dw;
  float* du;          // [H, HD]
  float* ds0;         // [B, H, HD, HD], or null
  int B, S, H;
};

__device__ __forceinline__ int chunks(int S) { return (S + C - 1) / C; }

// Launch 1: block (b, h); thread x holds row x / 4, columns 16 (x % 4) ..
// + 15 of the state. Writes the state before each chunk, then a_t and
// vdy_t of every step.
__global__ void __launch_bounds__(CK_NT) ckpt_kernel(const Args a) {
  const int bh = blockIdx.x, h = bh % a.H, b = bh / a.H;
  const int i = threadIdx.x / 4, j0 = CK_CPT * (threadIdx.x % 4);
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.S * a.H + h) * HD;  // (b, 0, h, 0)
  const int nch = chunks(a.S);
  float st[CK_CPT];
  const size_t s0 = (size_t)bh * HD * HD + (size_t)i * HD + j0;
#pragma unroll
  for (int e = 0; e < CK_CPT; e += 4) {
    const float4 x = a.s_in == nullptr
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : *reinterpret_cast<const float4*>(a.s_in + s0 + e);
    st[e] = x.x, st[e + 1] = x.y, st[e + 2] = x.z, st[e + 3] = x.w;
  }
  float* ck = a.ckpt + (size_t)bh * nch * HD * HD + (size_t)i * HD + j0;
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int e = 0; e < CK_CPT; e += 4)
      *reinterpret_cast<float4*>(ck + (size_t)c * HD * HD + e) =
          make_float4(st[e], st[e + 1], st[e + 2], st[e + 3]);
    if (c + 1 == nch) break;  // the last chunk's end state is not needed
    const size_t off = base + (size_t)c * C * step;
    const float* kp = a.k + off + i;
    const float* wp = a.w + off + i;
    const float4* vp = reinterpret_cast<const float4*>(a.v + off + j0);
#pragma unroll 4
    for (int t = 0; t < C; ++t) {
      const float kk = __ldg(kp + t * step), ww = __ldg(wp + t * step);
      float vv[CK_CPT];
#pragma unroll
      for (int e = 0; e < CK_CPT; e += 4) {
        const float4 x = __ldg(vp + t * (step / 4) + e / 4);
        vv[e] = x.x, vv[e + 1] = x.y, vv[e + 2] = x.z, vv[e + 3] = x.w;
      }
      // K7's rounding: kv = k v, then S = fma(w, S, kv)
#pragma unroll
      for (int e = 0; e < CK_CPT; ++e)
        st[e] = __fmaf_rn(ww, st[e], __fmul_rn(kk, vv[e]));
    }
  }
  // a_t = sum_i r_i (u_i k_i), each product and the sum in f64 (K7's
  // terms), and vdy_t = sum_j v_j dy_j the same way; one step a thread
  for (int t = threadIdx.x; t < a.S; t += CK_NT) {
    const size_t off = base + (size_t)t * step;
    const float4* r4 = reinterpret_cast<const float4*>(a.r + off);
    const float4* k4 = reinterpret_cast<const float4*>(a.k + off);
    const float4* v4 = reinterpret_cast<const float4*>(a.v + off);
    const float4* y4 = reinterpret_cast<const float4*>(a.dy + off);
    const float* u = a.u + (size_t)h * HD;
    double sa = 0.0, sv = 0.0;
#pragma unroll 4
    for (int m = 0; m < HD / 4; ++m) {
      const float4 rr = __ldg(r4 + m), kk = __ldg(k4 + m);
      const float4 vv = __ldg(v4 + m), yy = __ldg(y4 + m);
      const float rx[4] = {rr.x, rr.y, rr.z, rr.w};
      const float kx[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
      const float yx[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa = __fma_rn(double(rx[e]),
                      __dmul_rn(double(__ldg(u + 4 * m + e)), double(kx[e])),
                      sa);
        sv = __fma_rn(double(vx[e]), double(yx[e]), sv);
      }
    }
    const size_t o = ((size_t)b * a.S + t) * a.H + h;
    a.at[o] = static_cast<float>(sa);
    a.vdy[o] = static_cast<float>(sv);
  }
}

struct Smem {
  float r[C][RB], k[C][RB], w[C][RB];  // the block's rows of the chunk
  float4 v[C][HD / 4], dy[C][HD / 4];
  float vdy[C];
  float pv[WARPS][D][HD];  // dv's partial sums of each warp's two rows
};

__device__ __forceinline__ void update(float (&s)[CPT], float kk, float ww,
                                       float4 v) {
  const float vv[CPT] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < CPT; ++e)
    s[e] = __fmaf_rn(ww, s[e], __fmul_rn(kk, vv[e]));
}

// Launch 2: block (b, h, g) takes rows RB g .. RB g + RB - 1; thread x has
// row RB g + x / TPR (two rows a warp), columns CPT (x % TPR) .. + 3.
__global__ void __launch_bounds__(NT, 2) bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int g = blockIdx.x % G, bh = blockIdx.x / G;
  const int h = bh % a.H, b = bh / a.H;
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int ri = threadIdx.x / TPR, q = threadIdx.x % TPR;
  const int i = RB * g + ri, j0 = CPT * q;
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.S * a.H + h) * HD;
  const int nch = chunks(a.S);
  const float uu = a.u[(size_t)h * HD + i];
  const size_t se = (size_t)bh * HD * HD + (size_t)i * HD + j0;  // my state

  float ds[CPT];  // dS_t, the gradient of the state after step t
  {
    const float4 x = a.ds_T == nullptr
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : *reinterpret_cast<const float4*>(a.ds_T + se);
    ds[0] = x.x, ds[1] = x.y, ds[2] = x.z, ds[3] = x.w;
  }
  float du_acc = 0.0f;
  float* part = a.dv_part + (size_t)g * a.B * a.S * step;

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, a.S - t0);
    __syncthreads();  // the last chunk is done with shared memory
    for (int x = threadIdx.x; x < n * RB; x += NT) {
      const int t = x / RB, rr = x % RB;
      const size_t o = base + (size_t)(t0 + t) * step + RB * g + rr;
      sm.r[t][rr] = __ldg(a.r + o);
      sm.k[t][rr] = __ldg(a.k + o);
      sm.w[t][rr] = __ldg(a.w + o);
    }
    for (int x = threadIdx.x; x < n * (HD / 4); x += NT) {
      const int t = x / (HD / 4), c4 = x % (HD / 4);
      const size_t o = base + (size_t)(t0 + t) * step;
      sm.v[t][c4] = __ldg(reinterpret_cast<const float4*>(a.v + o) + c4);
      sm.dy[t][c4] = __ldg(reinterpret_cast<const float4*>(a.dy + o) + c4);
    }
    for (int t = threadIdx.x; t < n; t += NT)
      sm.vdy[t] = a.vdy[((size_t)b * a.S + t0 + t) * a.H + h];
    float s[CPT];
    {
      const float4 x = *reinterpret_cast<const float4*>(
          a.ckpt + ((size_t)bh * nch + c) * HD * HD + (size_t)i * HD + j0);
      s[0] = x.x, s[1] = x.y, s[2] = x.z, s[3] = x.w;
    }
    __syncthreads();
    // the state at the start of each sub-chunk
    float sub[NSUB][CPT];
#pragma unroll
    for (int sc = 0; sc < NSUB; ++sc) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) sub[sc][e] = s[e];
      if (sc + 1 < NSUB) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = sc * D + d;
          if (t < n) update(s, sm.k[t][ri], sm.w[t][ri], sm.v[t][q]);
        }
      }
    }
#pragma unroll
    for (int sc = NSUB - 1; sc >= 0; --sc) {
      const int nd = min(D, n - sc * D);  // steps of this sub-chunk
      if (nd <= 0) continue;
      float st[D][CPT];  // st[d]: the state before step sc D + d
#pragma unroll
      for (int e = 0; e < CPT; ++e) s[e] = sub[sc][e];
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int e = 0; e < CPT; ++e) st[d][e] = s[e];
        const int t = sc * D + d;
        if (d + 1 < nd) update(s, sm.k[t][ri], sm.w[t][ri], sm.v[t][q]);
      }
#pragma unroll
      for (int d = D - 1; d >= 0; --d) {
        if (d >= nd) continue;
        const int t = sc * D + d;
        const float rr = sm.r[t][ri], kk = sm.k[t][ri], ww = sm.w[t][ri];
        const float4 v4 = sm.v[t][q], y4 = sm.dy[t][q];
        const float vv[CPT] = {v4.x, v4.y, v4.z, v4.w};
        const float yy[CPT] = {y4.x, y4.y, y4.z, y4.w};
        float pr = 0.0f, pk = 0.0f, pw = 0.0f, pv[CPT];
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          pr = __fmaf_rn(st[d][e], yy[e], pr);
          pk = __fmaf_rn(ds[e], vv[e], pk);
          pw = __fmaf_rn(ds[e], st[d][e], pw);
          pv[e] = __fmul_rn(ds[e], kk);
          ds[e] = __fmaf_rn(ww, ds[e], __fmul_rn(rr, yy[e]));
        }
        // the row's sums over its 16 lanes (the same bits in each lane)
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) {
          pr = __fadd_rn(pr, __shfl_xor_sync(0xffffffffu, pr, o));
          pk = __fadd_rn(pk, __shfl_xor_sync(0xffffffffu, pk, o));
          pw = __fadd_rn(pw, __shfl_xor_sync(0xffffffffu, pw, o));
        }
        // dv's column sums over the warp's two rows
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          pv[e] = __fadd_rn(pv[e], __shfl_xor_sync(0xffffffffu, pv[e], TPR));
        if (lane < TPR)
          *reinterpret_cast<float4*>(&sm.pv[wp][d][j0]) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
        if (q == 0) {
          const float vd = sm.vdy[t];
          const size_t o = base + (size_t)(t0 + t) * step + i;
          a.dr[o] = __fmaf_rn(__fmul_rn(uu, kk), vd, pr);
          a.dk[o] = __fmaf_rn(__fmul_rn(rr, uu), vd, pk);
          a.dw[o] = pw;
          du_acc = __fmaf_rn(__fmul_rn(rr, kk), vd, du_acc);
        }
      }
      __syncthreads();
      // the sub-chunk's dv partials over the block's rows, warps in order
      for (int x = threadIdx.x; x < nd * HD; x += NT) {
        const int d = x / HD, j = x % HD;
        float p = sm.pv[0][d][j];
#pragma unroll
        for (int m = 1; m < WARPS; ++m) p = __fadd_rn(p, sm.pv[m][d][j]);
        part[base + (size_t)(t0 + sc * D + d) * step + j] = p;
      }
      __syncthreads();
    }
  }
  if (a.ds0 != nullptr)
    *reinterpret_cast<float4*>(a.ds0 + se) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
  if (q == 0) a.du_part[(size_t)bh * HD + i] = du_acc;
}

// Launch 3: dv = fma(a_t, dy, the G partials added in order); a thread
// four columns.
__global__ void dv_kernel(const Args a) {
  const size_t n4 = (size_t)a.B * a.S * a.H * (HD / 4);
  const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n4) return;
  const size_t plane = (size_t)a.B * a.S * a.H * HD;
  const float at = a.at[x / (HD / 4)];
  float4 p = reinterpret_cast<const float4*>(a.dv_part)[x];
#pragma unroll
  for (int m = 1; m < G; ++m) {
    const float4 o = reinterpret_cast<const float4*>(a.dv_part + m * plane)[x];
    p.x = __fadd_rn(p.x, o.x), p.y = __fadd_rn(p.y, o.y);
    p.z = __fadd_rn(p.z, o.z), p.w = __fadd_rn(p.w, o.w);
  }
  const float4 y = reinterpret_cast<const float4*>(a.dy)[x];
  reinterpret_cast<float4*>(a.dv)[x] =
      make_float4(__fmaf_rn(at, y.x, p.x), __fmaf_rn(at, y.y, p.y),
                  __fmaf_rn(at, y.z, p.z), __fmaf_rn(at, y.w, p.w));
}

// Launch 4: du[h, i] = sum over b of du_part[b, h, i], in b's order.
__global__ void du_kernel(const Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.H * HD) return;
  float s = 0.0f;
  for (int b = 0; b < a.B; ++b)
    s = __fadd_rn(s, a.du_part[(size_t)b * a.H * HD + x]);
  a.du[x] = s;
}

cudaError_t set_smem() {
  return cudaFuncSetAttribute(bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sizeof(Smem));
}

}  // namespace

// The gradients of the WKV6 recurrence (see above). r, k, v, w, dy, dr,
// dk, dv, dw [B, S, H, hd]; u, du [H, hd]; s_in, ds_T (null: zeros), ds0
// (null: not wanted) [B, H, hd, hd]; the workspaces ckpt [B, H, ceil(S /
// 64), hd, hd], at and vdy [B, S, H], dv_part [4, B, S, H, hd], du_part [B,
// H, hd]. All f32 and contiguous, all but u, at, vdy and du_part 16-byte
// aligned. Takes hd = 64 and S >= 1 only. Launches four kernels on
// `stream`; returns cudaGetLastError() after them (0 = ok).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* s_in, const void* dy,
                               const void* ds_T, void* ckpt, void* at,
                               void* vdy, void* dv_part, void* du_part,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, int B, int S, int H,
                               int hd, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  if (hd != HD || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {r, k, v, w, s_in, dy, ds_T,
                        static_cast<const void*>(ckpt),
                        static_cast<const void*>(dv_part),
                        static_cast<const void*>(dr),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv),
                        static_cast<const void*>(dw),
                        static_cast<const void*>(ds0)})
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B == 0 || H == 0) return 0;
  const cudaError_t e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(r),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(w),
               static_cast<const float*>(u),    static_cast<const float*>(s_in),
               static_cast<const float*>(dy),   static_cast<const float*>(ds_T),
               static_cast<float*>(ckpt),       static_cast<float*>(at),
               static_cast<float*>(vdy),        static_cast<float*>(dv_part),
               static_cast<float*>(du_part),    static_cast<float*>(dr),
               static_cast<float*>(dk),         static_cast<float*>(dv),
               static_cast<float*>(dw),         static_cast<float*>(du),
               static_cast<float*>(ds0),        B,
               S,                               H};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ckpt_kernel<<<B * H, CK_NT, 0, st>>>(a);
  bwd_kernel<<<B * H * G, NT, sizeof(Smem), st>>>(a);
  const size_t n4 = (size_t)B * S * H * (HD / 4);
  dv_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(a);
  du_kernel<<<(H * HD + 255) / 256, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bwd kernel's resources, into out[4]: threads a block, shared bytes a
// block, registers a thread, local (spill) bytes a thread; out[4] its
// resident blocks an SM (the occupancy calculator). Returns 0 or the CUDA
// error.
extern "C" int wkv6_bwd_occupancy(int* out, void* /*stream*/) {
  cudaError_t e = set_smem();
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bwd_kernel, NT,
                                                      sizeof(Smem));
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, bwd_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[5] = {NT, static_cast<int>(sizeof(Smem)), fa.numRegs,
                       static_cast<int>(fa.localSizeBytes), blocks};
  for (int x = 0; x < 5; ++x) out[x] = vals[x];
  return 0;
}
