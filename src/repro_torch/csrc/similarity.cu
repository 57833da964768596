// Masked pairwise similarity for Hopper (sm_90a), plain C interface.
//
//   out[g, i, j] = mask[g, i, j] ? (x_i . x_j * rsqrt(|x_i|^2 |x_j|^2 + 1e-8)
//                                   + 1) / 2
//                                : 0
//
// Replaces the Pallas kernel repro/kernels/similarity.py::_sim_kernel (K2),
// which the reference vmaps over the condensation groups: here one launch
// covers every group. x is [NG, G, d] in f32 or bf16, mask [NG, G, G] as
// bytes (torch.bool), out [NG, G, G] f32. The Gram sum and both square sums
// are f32 FMAs over the same shared-memory slabs, in a fixed order (no
// atomics, no split reduction, no TF32), so a run repeats bit for bit and a
// recompute under activation checkpointing takes the same decisions.
//
// Design: one block of 256 threads per (column tile, row tile, group) of a
// 64x64 output tile; each thread owns a 4x4 micro-tile strided by 16 so
// shared-memory reads are conflict-free and stores coalesce. The block
// first reads its mask tile: a tile with no True entry writes zeros and
// returns (the TPU kernel's tile-level early-out). The square sums come
// from the same slabs as the Gram product: threads 0..63 sum the rows of
// the row slab, threads 64..127 those of the column slab.
//
// What bounds it on an H100: at moe-gpt2's full width (64 groups of
// G = 128, d = 768) one launch does 1.6 GFLOP against 17 MB of rows, mask
// and output, so f32 operations (67 TFLOP/s outside the tensor cores):
// about 24 us. The square sums are recomputed by every tile of a row (the
// TPU kernel does the same); that is d/64 extra FMAs per output, 1/64 of
// the Gram work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BT = 64;   // output tile edge
constexpr int BK = 16;   // slab depth along d
constexpr int TM = 4;    // rows per thread, strided by 16
constexpr int NT = 256;  // threads per block: 16 x 16

template <typename TX>
__global__ void __launch_bounds__(NT)
sim_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ mask,
           float* __restrict__ out, int G, int d) {
  __shared__ float sA[BK][BT + 1];  // row slab, transposed
  __shared__ float sB[BK][BT + 1];  // column slab, transposed
  __shared__ float sxx[BT];
  __shared__ float syy[BT];
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * BT;
  const int j0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t gG = (size_t)g * G;
  const uint8_t* mg = mask + gG * G;
  float* og = out + gG * G;

  // ---- tile-level early-out: any True entry in this mask tile?
  int any = 0;
  for (int e = tid; e < BT * BT; e += NT) {
    const int i = i0 + e / BT, j = j0 + e % BT;
    if (i < G && j < G && mg[(size_t)i * G + j]) any = 1;
  }
  if (!__syncthreads_or(any)) {
    for (int e = tid; e < BT * BT; e += NT) {
      const int i = i0 + e / BT, j = j0 + e % BT;
      if (i < G && j < G) og[(size_t)i * G + j] = 0.0f;
    }
    return;
  }

  const TX* xg = x + gG * d;
  float acc[TM][TM] = {};
  float sq = 0.0f;  // threads 0..63: |row|^2, 64..127: |column|^2
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BT * BK; e += NT) {
      const int m = e / BK, k = e % BK;
      const int kk = k0 + k;
      const int ri = i0 + m, rj = j0 + m;
      sA[k][m] = (ri < G && kk < d) ? to_f32(xg[(size_t)ri * d + kk]) : 0.0f;
      sB[k][m] = (rj < G && kk < d) ? to_f32(xg[(size_t)rj * d + kk]) : 0.0f;
    }
    __syncthreads();
    if (tid < BT) {
#pragma unroll
      for (int k = 0; k < BK; ++k) sq = fmaf(sA[k][tid], sA[k][tid], sq);
    } else if (tid < 2 * BT) {
#pragma unroll
      for (int k = 0; k < BK; ++k)
        sq = fmaf(sB[k][tid - BT], sB[k][tid - BT], sq);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TM];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        a[t] = sA[k][ty + 16 * t];
        b[t] = sB[k][tx + 16 * t];
      }
#pragma unroll
      for (int p = 0; p < TM; ++p) {
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
    }
    __syncthreads();
  }
  if (tid < BT) sxx[tid] = sq;
  else if (tid < 2 * BT) syy[tid - BT] = sq;
  __syncthreads();

#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int i = i0 + ty + 16 * p;
    if (i >= G) continue;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= G) continue;
      const size_t o = (size_t)i * G + j;
      float s = 0.0f;
      if (mg[o]) {
        const float v = sxx[ty + 16 * p] * syy[tx + 16 * q] + 1e-8f;
        s = (acc[p][q] * (1.0f / sqrtf(v)) + 1.0f) * 0.5f;
      }
      og[o] = s;
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// x_bf16 selects bf16 (1) or f32 (0) rows. Nothing is allocated here.
extern "C" int masked_similarity_launch(const void* x, const void* mask,
                                        void* out, int NG, int G, int d,
                                        int x_bf16, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + BT - 1) / BT, (G + BT - 1) / BT, NG);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    sim_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), m, o, G, d);
  else
    sim_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(x), m, o,
                                          G, d);
  return static_cast<int>(cudaGetLastError());
}
