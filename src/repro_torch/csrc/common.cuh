// Helpers shared by the hand-written kernels: bf16 <-> f32 and the
// expert FFN's activations with their derivatives.
#pragma once

#include <cuda_bf16.h>

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
