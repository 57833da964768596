// Backward of the grouped gated expert FFN for Hopper (sm_90a), plain C
// interface. The forward is csrc/expert_ffn.cu (K1):
//
//   gt = h @ Wg, up = h @ Wu, a = act(gt), y = (a * up) @ Wd
//
// and, given dy, with dhh = dy @ Wd^T:
//
//   dWd = (a * up)^T @ dy    dup = dhh * a    dgt = dhh * up * act'(gt)
//   dWu = h^T @ dup          dWg = h^T @ dgt  dh  = dup @ Wu^T + dgt @ Wg^T
//
// The Pallas kernel K1 (repro/kernels/expert_ffn.py::_ffn_kernel) has no
// backward: the reference differentiates its einsum path with XLA. This is
// the port's own, so that training runs through K1. h and dy are [E, R, d]
// in f32 or bf16, the weights [E, d, F] / [E, F, d] in f32 or bf16; every
// product is an f32 FMA (no TF32), the weight gradients are f32 and dh is
// in h's type. Ragged R is masked. Nothing is carried between blocks and
// nothing is added atomically, so a run repeats bit for bit.
//
// Design: three kernels on the caller's stream, with three f32 scratch
// tensors [E, R, F] (P = a * up, DU = dup, DG = dgt) that the wrapper
// allocates; the forward's hidden is recomputed, not saved.
//   1. hidden: one block per (F tile, R tile, expert) recomputes the gt and
//      up tiles and the dhh tile from shared-memory slabs of h, dy and the
//      three weights (three accumulators over d), then writes P, DU, DG.
//   2. wgrad:  one block per (64x64 output tile, product, expert) forms
//      dWu, dWg or dWd as A^T @ B, reducing over all R rows inside the
//      block.
//   3. dh:     one block per (d tile, R tile, expert) reduces
//      DU @ Wu^T + DG @ Wg^T over F.
// Each block is 256 threads, each owning a 4x4 micro-tile strided by 16,
// so a block covers 64 rows (masked where R is ragged or short) and 64
// columns.
//
// What bounds it on an H100: operations. The backward does 8 matrix
// products of the forward's size (two recomputed, dhh, three weight
// gradients, two for dh): at moe-gpt2's train width ([16, 2048, 768] x
// 3072) 1.24 TFLOP, 18.5 ms at the 67 TFLOP/s f32 rate. Later work: bf16
// wgmma with f32 accumulators, and keeping P/DU/DG out of device memory.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;   // rows of the output tile
constexpr int BN = 64;   // columns of the output tile
constexpr int BK = 16;   // depth of one shared-memory slab
constexpr int TM = 4;    // rows per thread (strided by 16)
constexpr int TN = 4;    // columns per thread (strided by 16)
constexpr int NT = 256;  // threads per block: 16 x 16

// ---- 1. recompute gt, up and dhh; write P, DU, DG ------------------------
template <typename TH, typename TW>
__global__ void __launch_bounds__(NT)
hidden_kernel(const TH* __restrict__ h, const TH* __restrict__ dy,
              const TW* __restrict__ wu, const TW* __restrict__ wg,
              const TW* __restrict__ wd, float* __restrict__ P,
              float* __restrict__ DU, float* __restrict__ DG, int R, int d,
              int F, int act) {
  __shared__ float sH[BK][BM + 1];
  __shared__ float sY[BK][BM + 1];
  __shared__ float sU[BK][BN];
  __shared__ float sG[BK][BN];
  __shared__ float sD[BK][BN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TH* he = h + (size_t)e * R * d;
  const TH* ye = dy + (size_t)e * R * d;
  const TW* ue = wu + (size_t)e * d * F;
  const TW* ge = wg + (size_t)e * d * F;
  const TW* de = wd + (size_t)e * F * d;
  float au[TM][TN] = {};
  float ag[TM][TN] = {};
  float ad[TM][TN] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int r = r0 + m, kk = k0 + k;
      const bool ok = r < R && kk < d;
      const size_t o = (size_t)r * d + kk;
      sH[k][m] = ok ? to_f32(he[o]) : 0.0f;
      sY[k][m] = ok ? to_f32(ye[o]) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      const int kk = k0 + k, f = f0 + n;
      const bool ok = kk < d && f < F;
      const size_t o = (size_t)kk * F + f;
      sU[k][n] = ok ? to_f32(ue[o]) : 0.0f;
      sG[k][n] = ok ? to_f32(ge[o]) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {  // Wd^T: coalesced along d
      const int n = i / BK, k = i % BK;
      const int kk = k0 + k, f = f0 + n;
      sD[k][n] = (kk < d && f < F) ? to_f32(de[(size_t)f * d + kk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TM], u[TN], g[TN], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = sH[k][ty + 16 * i];
        b[i] = sY[k][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        u[j] = sU[k][tx + 16 * j];
        g[j] = sG[k][tx + 16 * j];
        w[j] = sD[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          au[i][j] = fmaf(a[i], u[j], au[i][j]);
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          ad[i][j] = fmaf(b[i], w[j], ad[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f >= F) continue;
      const size_t o = ((size_t)e * R + r) * F + f;
      const float gt = ag[i][j], up = au[i][j], dhh = ad[i][j];
      const float a = act_fn(gt, act);
      P[o] = a * up;
      DU[o] = dhh * a;
      DG[o] = dhh * up * act_grad(gt, act);
    }
  }
}

// ---- 2. weight gradients: C[m, n] = sum_r A[r, m] * B[r, n] ---------------
// One 64x64 tile of C; rows of A and B are contiguous along m and n.
template <typename TA, typename TB>
__device__ __forceinline__ void atb_tile(const TA* __restrict__ A,
                                         const TB* __restrict__ B,
                                         float* __restrict__ C, int R, int M,
                                         int N, int m0, int n0,
                                         float (*sA)[BN + 1],
                                         float (*sB)[BN + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[TM][TN] = {};
  for (int r0 = 0; r0 < R; r0 += BK) {
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, c = i % BN;
      const int r = r0 + k;
      sA[k][c] = (r < R && m0 + c < M) ? to_f32(A[(size_t)r * M + m0 + c])
                                       : 0.0f;
      sB[k][c] = (r < R && n0 + c < N) ? to_f32(B[(size_t)r * N + n0 + c])
                                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// blockIdx.z = which * E + e, which 0: dWu = h^T DU, 1: dWg = h^T DG,
// 2: dWd = P^T dy. blockIdx.x enumerates the 64x64 tiles of the output.
template <typename TH>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const TH* __restrict__ h, const TH* __restrict__ dy,
             const float* __restrict__ P, const float* __restrict__ DU,
             const float* __restrict__ DG, float* __restrict__ dwu,
             float* __restrict__ dwg, float* __restrict__ dwd, int E, int R,
             int d, int F) {
  __shared__ float sA[BK][BN + 1];
  __shared__ float sB[BK][BN + 1];
  const int which = blockIdx.z / E;
  const int e = blockIdx.z % E;
  const size_t rd = (size_t)e * R * d, rf = (size_t)e * R * F;
  const size_t w = (size_t)e * d * F;
  const int M = which < 2 ? d : F;
  const int N = which < 2 ? F : d;
  const int nt = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / nt) * BN;
  const int n0 = (blockIdx.x % nt) * BN;
  if (m0 >= M) return;
  if (which == 0)
    atb_tile(h + rd, DU + rf, dwu + w, R, M, N, m0, n0, sA, sB);
  else if (which == 1)
    atb_tile(h + rd, DG + rf, dwg + w, R, M, N, m0, n0, sA, sB);
  else
    atb_tile(P + rf, dy + rd, dwd + w, R, M, N, m0, n0, sA, sB);
}

// ---- 3. dh = DU @ Wu^T + DG @ Wg^T ----------------------------------------
template <typename TH, typename TW>
__global__ void __launch_bounds__(NT)
dh_kernel(const float* __restrict__ DU, const float* __restrict__ DG,
          const TW* __restrict__ wu, const TW* __restrict__ wg,
          TH* __restrict__ dh, int R, int d, int F) {
  __shared__ float sU[BK][BM + 1];
  __shared__ float sG[BK][BM + 1];
  __shared__ float sWu[BK][BN];
  __shared__ float sWg[BK][BN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* ue = DU + (size_t)e * R * F;
  const float* ge = DG + (size_t)e * R * F;
  const TW* wue = wu + (size_t)e * d * F;
  const TW* wge = wg + (size_t)e * d * F;
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int r = r0 + m, kk = k0 + k;
      const bool ok = r < R && kk < F;
      const size_t o = (size_t)r * F + kk;
      sU[k][m] = ok ? ue[o] : 0.0f;
      sG[k][m] = ok ? ge[o] : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {  // W^T: coalesced along F
      const int n = i / BK, k = i % BK;
      const int kk = k0 + k, c = c0 + n;
      const bool ok = kk < F && c < d;
      const size_t o = (size_t)c * F + kk;
      sWu[k][n] = ok ? to_f32(wue[o]) : 0.0f;
      sWg[k][n] = ok ? to_f32(wge[o]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TM], u[TN], g[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = sU[k][ty + 16 * i];
        b[i] = sG[k][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        u[j] = sWu[k][tx + 16 * j];
        g[j] = sWg[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i], u[j], acc[i][j]);
          acc[i][j] = fmaf(b[i], g[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) dh[((size_t)e * R + r) * d + c] = from_f32<TH>(acc[i][j]);
    }
  }
}

template <typename TH, typename TW>
void launch(const void* h, const void* dy, const void* wu, const void* wg,
            const void* wd, void* dh, float* dwu, float* dwg, float* dwd,
            float* P, float* DU, float* DG, int E, int R, int d, int F,
            int act, cudaStream_t s) {
  const TH* th = static_cast<const TH*>(h);
  const TH* tdy = static_cast<const TH*>(dy);
  const TW* tu = static_cast<const TW*>(wu);
  const TW* tg = static_cast<const TW*>(wg);
  const dim3 g1((F + BN - 1) / BN, (R + BM - 1) / BM, E);
  hidden_kernel<TH, TW><<<g1, NT, 0, s>>>(th, tdy, tu, tg,
                                          static_cast<const TW*>(wd), P, DU,
                                          DG, R, d, F, act);
  const int tiles = ((d + BN - 1) / BN) * ((F + BN - 1) / BN);
  wgrad_kernel<TH><<<dim3(tiles, 1, 3 * E), NT, 0, s>>>(
      th, tdy, P, DU, DG, dwu, dwg, dwd, E, R, d, F);
  const dim3 g3((d + BN - 1) / BN, (R + BM - 1) / BM, E);
  dh_kernel<TH, TW><<<g3, NT, 0, s>>>(DU, DG, tu, tg, static_cast<TH*>(dh),
                                      R, d, F);
}

}  // namespace

// Launches the three kernels on `stream`; returns cudaGetLastError()
// (0 = ok). h_bf16 / w_bf16 select bf16 (1) or f32 (0) storage of h and dy
// (and dh) / of the weights; act 0 = silu, 1 = gelu. dwu, dwg, dwd are f32
// outputs shaped like the weights; P, DU, DG are f32 scratch of E * R * F
// elements each. Nothing is allocated here.
extern "C" int expert_ffn_bwd_launch(const void* h, const void* dy,
                                     const void* wu, const void* wg,
                                     const void* wd, void* dh, void* dwu,
                                     void* dwg, void* dwd, void* P, void* DU,
                                     void* DG, int E, int R, int d, int F,
                                     int h_bf16, int w_bf16, int act,
                                     void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fu = static_cast<float*>(dwu);
  float* fg = static_cast<float*>(dwg);
  float* fd = static_cast<float*>(dwd);
  float* p = static_cast<float*>(P);
  float* du = static_cast<float*>(DU);
  float* dg = static_cast<float*>(DG);
  if (h_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(h, dy, wu, wg, wd, dh, fu, fg, fd,
                                         p, du, dg, E, R, d, F, act, s);
  else if (h_bf16)
    launch<__nv_bfloat16, float>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du,
                                 dg, E, R, d, F, act, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du,
                                 dg, E, R, d, F, act, s);
  else
    launch<float, float>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du, dg, E, R,
                         d, F, act, s);
  return static_cast<int>(cudaGetLastError());
}
