// Helpers shared by the hand-written kernels: bf16 <-> f32 and the
// expert FFN's activations with their derivatives.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in torch
}

// act 0 = silu, 1 = gelu (tanh approximation, jax.nn.gelu's default)
constexpr float GELU_K0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_K1 = 0.044715f;

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == 0) return x / (1.0f + expf(-x));
  return 0.5f * x * (1.0f + tanhf(GELU_K0 * (x + GELU_K1 * x * x * x)));
}

// d act / dx
__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == 0) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s * (1.0f + x * (1.0f - s));
  }
  const float t = tanhf(GELU_K0 * (x + GELU_K1 * x * x * x));
  const float du = GELU_K0 * (1.0f + 3.0f * GELU_K1 * x * x);  // du/dx
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// Group maps (K1's replica lanes). A launch over G row groups may take a
// map widx[G]: group g reads weight group widx[g], and -1 marks an idle
// group, which does no products and whose output is zero. A null map is
// the identity (group g reads weights g). Live groups count in ascending
// order; every thread that walks the tiles derives them the same way, so
// no list is built or stored.
__device__ __forceinline__ int map_live(const int* __restrict__ widx, int G) {
  int n = 0;
  for (int g = 0; g < G; ++g) n += widx[g] >= 0;
  return n;
}

// The group of the i-th live entry of widx (i < map_live(widx, G)).
__device__ __forceinline__ int map_nth_live(const int* __restrict__ widx,
                                            int G, int i) {
  for (int g = 0; g < G; ++g)
    if (widx[g] >= 0 && i-- == 0) return g;
  return G;
}

// Zeros the `per_group` elements of each idle group of out [G, ...]
// (blockIdx.y = g); live groups are left to the kernels that write them.
template <typename T>
__global__ void zero_idle_groups(const int* __restrict__ widx,
                                 T* __restrict__ out, size_t per_group) {
  if (widx[blockIdx.y] >= 0) return;
  T* o = out + (size_t)blockIdx.y * per_group;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per_group;
       i += (size_t)gridDim.x * blockDim.x)
    o[i] = from_f32<T>(0.0f);
}

template <typename T>
inline void launch_zero_idle(const int* widx, void* out, int G,
                             size_t per_group, cudaStream_t s) {
  const size_t blocks = (per_group + 255) / 256;
  const dim3 grid(blocks < 512 ? (unsigned)blocks : 512u, (unsigned)G);
  zero_idle_groups<T><<<grid, 256, 0, s>>>(widx, static_cast<T*>(out),
                                           per_group);
}
