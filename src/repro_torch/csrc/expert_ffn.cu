// Grouped gated expert FFN for Hopper (sm_90a), plain C interface.
//
//   out[e] = (act(h[e] @ w_gate[e]) * (h[e] @ w_up[e])) @ w_down[e]
//
// Replaces the Pallas kernel repro/kernels/expert_ffn.py::_ffn_kernel (K1).
// h is [E, R, d] in f32 or bf16, the weights [E, d, F] / [E, F, d] in f32
// or bf16, independently. Every product and sum is an f32 FMA (no TF32, no
// tensor cores), the hidden act(gt) * up stays f32, and the output is cast
// to h's type. Unlike the Pallas kernel, ragged R (any R >= 1) is masked.
//
// Design: two kernels on the caller's stream.
//   1. gate_up: one block per (F tile, R tile, expert) computes the up and
//      gate tiles together from shared-memory slabs of h and both weights,
//      and writes act(gt) * up to a wrapper-allocated f32 scratch [E, R, F].
//   2. down:    one block per (d tile, R tile, expert) multiplies that
//      hidden by w_down and writes the output tile in h's type.
// Each block is 256 threads over a (16*TM)x64 output tile, each thread a
// TMx4 micro-tile strided by 16 so shared-memory reads are conflict-free
// and global stores coalesce. Two tilings: TM=4 (64 rows, 16-deep slabs)
// for prefill, and TM=1 (16 rows, 32-deep slabs) for R <= 16, where a
// 64-row tile would spend 7/8 of its FMAs on padding and the deeper slab
// keeps more weight bytes in flight per block.
//
// What bounds it on an H100:
//   * decode (R = 8 rows per expert): weight bytes. One moe-gpt2 layer holds
//     3 x 16 x 768 x 3072 f32 weights = 453 MB, about 135 us at 3.35 TB/s,
//     against 1.8 GFLOP. The 16-row tiling streams each weight once.
//   * prefill (R = 256 rows per expert): operations. 58 GFLOP per layer in
//     f32 FMAs (67 TFLOP/s peak outside the tensor cores) against the same
//     453 MB of weights.
// Later work, not done here: bf16 wgmma with an f32 accumulator fed by TMA,
// which moves prefill onto the tensor cores, and fusing the hidden so it
// never goes through device memory.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BN = 64;   // columns of the output tile
constexpr int TN = 4;    // columns per thread (strided by 16)
constexpr int NT = 256;  // threads per block: 16 x 16
// TM: rows per thread (strided by 16), so 16 * TM rows per tile;
// BK: depth of one shared-memory slab. Both are template parameters.

template <int TM, int BK, typename TH, typename TW>
__global__ void __launch_bounds__(NT)
gate_up_kernel(const TH* __restrict__ h, const TW* __restrict__ wu,
               const TW* __restrict__ wg, float* __restrict__ hid, int R,
               int d, int F, int act) {
  constexpr int BM = 16 * TM;
  __shared__ float sA[BK][BM + 1];  // h slab, transposed; +1 breaks conflicts
  __shared__ float sU[BK][BN];
  __shared__ float sG[BK][BN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TH* he = h + (size_t)e * R * d;
  const TW* ue = wu + (size_t)e * d * F;
  const TW* ge = wg + (size_t)e * d * F;
  float au[TM][TN] = {};
  float ag[TM][TN] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int r = r0 + m, kk = k0 + k;
      sA[k][m] = (r < R && kk < d) ? to_f32(he[(size_t)r * d + kk]) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      const int kk = k0 + k, f = f0 + n;
      const bool ok = kk < d && f < F;
      const size_t o = (size_t)kk * F + f;
      sU[k][n] = ok ? to_f32(ue[o]) : 0.0f;
      sG[k][n] = ok ? to_f32(ge[o]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], u[TN], g[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        u[j] = sU[k][tx + 16 * j];
        g[j] = sG[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          au[i][j] = fmaf(a[i], u[j], au[i][j]);
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
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
      if (f < F)
        hid[((size_t)e * R + r) * F + f] = act_fn(ag[i][j], act) * au[i][j];
    }
  }
}

template <int TM, int BK, typename TH, typename TW>
__global__ void __launch_bounds__(NT)
down_kernel(const float* __restrict__ hid, const TW* __restrict__ wd,
            TH* __restrict__ out, int R, int d, int F) {
  constexpr int BM = 16 * TM;
  __shared__ float sA[BK][BM + 1];
  __shared__ float sB[BK][BN];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* he = hid + (size_t)e * R * F;
  const TW* de = wd + (size_t)e * F * d;
  float acc[TM][TN] = {};

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int r = r0 + m, kk = k0 + k;
      sA[k][m] = (r < R && kk < F) ? he[(size_t)r * F + kk] : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      const int kk = k0 + k, c = c0 + n;
      sB[k][n] = (kk < F && c < d) ? to_f32(de[(size_t)kk * d + c]) : 0.0f;
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
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) out[((size_t)e * R + r) * d + c] = from_f32<TH>(acc[i][j]);
    }
  }
}

template <int TM, int BK, typename TH, typename TW>
void launch_tiled(const void* h, const void* wu, const void* wg,
                  const void* wd, void* out, float* hid, int E, int R, int d,
                  int F, int act, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 block(NT);
  const dim3 g1((F + BN - 1) / BN, (R + BM - 1) / BM, E);
  const dim3 g2((d + BN - 1) / BN, (R + BM - 1) / BM, E);
  gate_up_kernel<TM, BK, TH, TW><<<g1, block, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(wu),
      static_cast<const TW*>(wg), hid, R, d, F, act);
  down_kernel<TM, BK, TH, TW><<<g2, block, 0, stream>>>(
      hid, static_cast<const TW*>(wd), static_cast<TH*>(out), R, d, F);
}

template <typename TH, typename TW>
void launch(const void* h, const void* wu, const void* wg, const void* wd,
            void* out, float* hid, int E, int R, int d, int F, int act,
            cudaStream_t stream) {
  if (R <= 16)
    launch_tiled<1, 32, TH, TW>(h, wu, wg, wd, out, hid, E, R, d, F, act,
                                stream);
  else
    launch_tiled<4, 16, TH, TW>(h, wu, wg, wd, out, hid, E, R, d, F, act,
                                stream);
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// h_bf16 / w_bf16 select bf16 (1) or f32 (0) storage; act 0 = silu, 1 = gelu.
// `hid` is f32 scratch of E * R * F elements; nothing is allocated here.
extern "C" int expert_ffn_launch(const void* h, const void* wu, const void* wg,
                                 const void* wd, void* out, void* hid, int E,
                                 int R, int d, int F, int h_bf16, int w_bf16,
                                 int act, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(hid);
  if (h_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(h, wu, wg, wd, out, hf, E, R, d, F,
                                         act, s);
  else if (h_bf16)
    launch<__nv_bfloat16, float>(h, wu, wg, wd, out, hf, E, R, d, F, act, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(h, wu, wg, wd, out, hf, E, R, d, F, act, s);
  else
    launch<float, float>(h, wu, wg, wd, out, hf, E, R, d, F, act, s);
  return static_cast<int>(cudaGetLastError());
}
