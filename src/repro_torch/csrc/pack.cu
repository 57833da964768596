// Dedup-wire pack and quantize for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/pack.py::pack_quantize (K4):
// the gate-mask -> dedup-pack -> quantize step of the deduplicated
// hierarchical wire (paper §VI's token_to_node packing). Given the slot ->
// token map tok (-1 = empty slot), wire row r is source row x[tok[r]], or a
// zero row, then
//   - f8 (pack_quant_kernel): zero-padded to a whole number of 32-element
//     blocks; per block amax = max |x| in f32, scale = amax * (1/448) (1.0
//     for an all-zero block), q = float8_e4m3fn(x / scale) with IEEE
//     division and round-to-nearest-even; writes q [R, d_pad] (bytes) and
//     the scales [R, d_pad / 32] f32;
//   - cast (pack_cast_kernel): the row in the wire's type (f32 or bf16,
//     round-to-nearest-even).
// Bit for bit the reference's codec (repro/comm/dtypes.py::quantize_rows):
// the scale multiplies by the f32 reciprocal and the payload divides, and
// the f32 -> e4m3 conversion is PyTorch's own (c10's
// fp8e4m3fn_from_fp32_value: round to nearest even, |x| >= 480 -> NaN;
// the scale keeps |x / scale| <= 448). This file must not be built with
// --use_fast_math.
//
// Design (f8, pack_quant_kernel, d a multiple of 8): one warp per wire
// row, eight rows per block; a lane holds 8 consecutive elements (one
// 16-byte load of bf16, two of f32), so 4 lanes share a 32-element scale
// block and its amax takes two shuffle levels; the payload goes out 8
// bytes a lane, the scale from one lane in four; tok is read once per
// warp. An empty slot (-1; about three quarters of the expert-parallel
// path's slots) loads nothing and writes its zero row and 1.0 scales in
// 16-byte stores. pack_quant_scalar_kernel (one block per row, one
// element per lane, the amax by a butterfly over the warp) takes any other
// d. cast (pack_cast_kernel): one block per row, its threads striding over
// the row; at the path's shape it runs at about two thirds of its byte
// bound by device time, so it kept its first design.
//
// The backward (pack_quant_bwd_kernel) is the port's own: the reference
// trains through its jnp path, whose gradient JAX forms by transposing
// quantize_rows then dequantize_rows primitive by primitive. Given the
// cotangent g of the dequantized wire rows, moved back to the sending rank
// (the wire's collectives are permutations, so the row-local arithmetic
// below is unchanged by the move), each 32-element block recomputes its
// amax, scale v and payload q from the source row and forms
//   ct_v = sum(q * g) - sum(f8(g * v) / v^2 * x)    (0 for an all-zero block)
//   dx   = f8(g * v) / v  +  sign(x) * ct_v * (1/448) / n_ties  on the ties
// with f8(.) the e4m3 cast the reference applies to the payload's
// cotangent, so cotangents below e4m3's range come back as 0. Its
// arithmetic per element is the forward's (the same scale and payload, bit
// for bit) and the scalar kernel's; only the two sums run in another order
// than the plain version's, a tolerance-level difference.
// Design (pack_quant_bwd_kernel, d a multiple of 8): one warp per wire row,
// eight rows per block; a lane holds 8 consecutive elements (16-byte loads
// of bf16, two of f32), so 4 lanes share a scale block and its amax, tie
// count and two sums take two shuffle levels each. Every load of a row (up
// to 1024 elements) is in flight before its arithmetic starts, and the
// result goes out in 16-byte stores. pack_quant_bwd_scalar_kernel (one element per
// lane, one block per row) takes any other d.
//
// What bounds it on an H100: bytes (each wire row reads a d-wide source
// row and writes d_pad bytes plus scales, or a d-wide cast row; the
// backward reads the source row and the cotangent and writes one row).
// The backward's arithmetic comes next: two IEEE divisions per element
// (payload, cotangent) and two e4m3 round trips, which stay as they are, for
// the bits; the conversions take no branch and decode from the bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BLOCK = 32;
constexpr float F8_INV = 1.0f / 448.0f;

// c10::detail::fp8e4m3fn_from_fp32_value, step for step; its three cases
// (NaN, subnormal, normal) are all computed and one selected, so the
// conversion has no branch
__device__ __forceinline__ uint8_t f32_to_e4m3fn(float f) {
  constexpr uint32_t fp8_max = UINT32_C(1087) << 20;  // 480.0f
  constexpr uint32_t denorm_mask = UINT32_C(141) << 23;
  uint32_t f_bits = __float_as_uint(f);
  const uint32_t sign = f_bits & UINT32_C(0x80000000);
  f_bits ^= sign;
  // subnormal in e4m3: let the f32 adder round, then take the bits
  const uint32_t sub = __float_as_uint(__fadd_rn(
      __uint_as_float(f_bits), __uint_as_float(denorm_mask))) - denorm_mask;
  const uint32_t mant_odd = (f_bits >> 20) & 1;
  const uint32_t nrm =
      (f_bits + (static_cast<uint32_t>(7 - 127) << 23) + 0x7FFFF + mant_odd) >>
      20;
  const uint32_t result = f_bits >= fp8_max                    ? 0x7fu
                          : f_bits < (UINT32_C(121) << 23) ? sub
                                                               : nrm;
  return static_cast<uint8_t>(result | (sign >> 24));
}

// c10::detail::fp8e4m3fn_to_fp32_value's values, exact, from the bits: a
// normal (1 + m / 8) 2^(e - 7) has f32 exponent field e + 120 and mantissa
// m << 20; a subnormal m 2^-9 is (m + 2^23) - 2^23 scaled
__device__ __forceinline__ float e4m3fn_to_f32(uint8_t b) {
  const uint32_t e = (b >> 3) & 0xF, m = b & 7;
  const float sub =
      (__uint_as_float(0x4B000000u | m) - 8388608.0f) * 0.001953125f;
  float v = e ? __uint_as_float(((e + 120) << 23) | (m << 20)) : sub;
  if (e == 0xF && m == 7) v = __int_as_float(0x7fc00000);  // NaN
  return (b & 0x80) ? -v : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f8, any d: one block per wire row, one element per lane
template <typename T>
__global__ void __launch_bounds__(NT)
pack_quant_scalar_kernel(const T* __restrict__ x, const int* __restrict__ tok,
                         uint8_t* __restrict__ q, float* __restrict__ sc,
                         int n_src, int d, int d_pad) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = tok[row];
  if (t >= n_src) __trap();  // an index out of range is a bug
  const int nb = d_pad / BLOCK;
  for (int b = warp; b < nb; b += NT / 32) {
    const int c = b * BLOCK + lane;
    float v = 0.0f;
    if (t >= 0 && c < d) v = to_f32(x[(size_t)t * d + c]);
    float a = fabsf(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    const float s = a > 0.0f ? __fmul_rn(a, F8_INV) : 1.0f;
    q[(size_t)row * d_pad + c] = f32_to_e4m3fn(__fdiv_rn(v, s));
    if (lane == 0) sc[(size_t)row * nb + b] = s;
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NT)
pack_cast_kernel(const Tin* __restrict__ x, const int* __restrict__ tok,
                 Tout* __restrict__ out, int n_src, int d) {
  const int row = blockIdx.x;
  const int t = tok[row];
  if (t >= n_src) __trap();
  Tout* o = out + (size_t)row * d;
  for (int c = threadIdx.x; c < d; c += NT)
    o[c] = from_f32<Tout>(t >= 0 ? to_f32(x[(size_t)t * d + c]) : 0.0f);
}

// dx [R, d] (x's type) of the rows x[tok[r]] (tok null: row r itself), any d
template <typename T>
__global__ void __launch_bounds__(NT)
pack_quant_bwd_scalar_kernel(const T* __restrict__ x,
                             const int* __restrict__ tok,
                             const T* __restrict__ g, T* __restrict__ dx,
                             int n_src, int d, int d_pad) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = tok == nullptr ? row : tok[row];
  if (t >= n_src) __trap();
  const int nb = d_pad / BLOCK;
  for (int b = warp; b < nb; b += NT / 32) {
    const int c = b * BLOCK + lane;
    float xv = 0.0f, gv = 0.0f;
    if (c < d) {
      if (t >= 0) xv = to_f32(x[(size_t)t * d + c]);
      gv = to_f32(g[(size_t)row * d + c]);
    }
    const float a = fabsf(xv);
    float amax = a;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const bool tie = a == amax;
    const int n_ties = __popc(__ballot_sync(0xffffffffu, tie));
    const bool live = amax > 0.0f;
    const float v = live ? __fmul_rn(amax, F8_INV) : 1.0f;
    const float q = e4m3fn_to_f32(f32_to_e4m3fn(__fdiv_rn(xv, v)));
    const float bt = e4m3fn_to_f32(f32_to_e4m3fn(__fmul_rn(gv, v)));
    const float bm = warp_sum(__fmul_rn(q, gv));
    const float inv_v2 = __fdiv_rn(1.0f, __fmul_rn(v, v));
    const float bw = warp_sum(__fmul_rn(__fmul_rn(bt, inv_v2), xv));
    const float cc = live ? __fadd_rn(bm, -bw) : 0.0f;
    const float ch = tie ? __fdiv_rn(__fmul_rn(cc, F8_INV),
                                     static_cast<float>(n_ties)) : 0.0f;
    const float out = __fadd_rn(__fadd_rn(__fdiv_rn(bt, v),
                                          xv >= 0.0f ? ch : 0.0f),
                                -(xv >= 0.0f ? 0.0f : ch));
    if (c < d) dx[(size_t)row * d + c] = from_f32<T>(out);
  }
}

constexpr int BWD_ROWS = 8;  // rows per block of the vector backward
constexpr int BWD_PASSES = 4;  // 256-element passes of a row held in flight

// 8 elements from 16-byte words: one word of bf16, two of f32
template <typename T>
__device__ __forceinline__ void unpack8(const uint4 (&w)[sizeof(T) / 2],
                                        float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[4 * k] = __uint_as_float(w[k].x);
      v[4 * k + 1] = __uint_as_float(w[k].y);
      v[4 * k + 2] = __uint_as_float(w[k].z);
      v[4 * k + 3] = __uint_as_float(w[k].w);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// the vector backward: as pack_quant_bwd_scalar_kernel, d a multiple of 8
// and every row 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(BWD_ROWS * 32)
pack_quant_bwd_kernel(const T* __restrict__ x, const int* __restrict__ tok,
                      const T* __restrict__ g, T* __restrict__ dx, int R,
                      int n_src, int d) {
  constexpr int W = sizeof(T) / 2;  // 16-byte words per lane per pass
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * BWD_ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int t = tok == nullptr ? row : tok[row];
  if (t >= n_src) __trap();
  for (int base = 0; base < d; base += 256 * BWD_PASSES) {
    uint4 gw[BWD_PASSES][W], xw[BWD_PASSES][W];
#pragma unroll
    for (int u = 0; u < BWD_PASSES; ++u) {
      const int c = base + 256 * u + 8 * lane;
      const bool in = c < d;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const uint4 z = make_uint4(0, 0, 0, 0);
        gw[u][k] = in ? reinterpret_cast<const uint4*>(
                            g + (size_t)row * d + c)[k] : z;
        xw[u][k] = in && t >= 0 ? reinterpret_cast<const uint4*>(
                                      x + (size_t)t * d + c)[k] : z;
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_PASSES; ++u) {
      const int c = base + 256 * u + 8 * lane;
      if (base + 256 * u >= d) break;  // the whole warp's pass lies past d
      float xv[8], gv[8];
      unpack8<T>(xw[u], xv);
      unpack8<T>(gw[u], gv);
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(xv[i]));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const bool live = amax > 0.0f;
      const float v = live ? __fmul_rn(amax, F8_INV) : 1.0f;
      const float inv_v2 = __fdiv_rn(1.0f, __fmul_rn(v, v));
      float bt[8], bm = 0.0f, bw = 0.0f;
      int ties = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ties += fabsf(xv[i]) == amax;
        const float q = e4m3fn_to_f32(f32_to_e4m3fn(__fdiv_rn(xv[i], v)));
        bt[i] = e4m3fn_to_f32(f32_to_e4m3fn(__fmul_rn(gv[i], v)));
        bm = __fadd_rn(bm, __fmul_rn(q, gv[i]));
        bw = __fadd_rn(bw, __fmul_rn(__fmul_rn(bt[i], inv_v2), xv[i]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        ties += __shfl_xor_sync(0xffffffffu, ties, o);
        bm = __fadd_rn(bm, __shfl_xor_sync(0xffffffffu, bm, o));
        bw = __fadd_rn(bw, __shfl_xor_sync(0xffffffffu, bw, o));
      }
      const float cc = live ? __fadd_rn(bm, -bw) : 0.0f;
      const float ch = __fdiv_rn(__fmul_rn(cc, F8_INV),
                                 static_cast<float>(ties));
      float out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float chi = fabsf(xv[i]) == amax ? ch : 0.0f;
        out[i] = __fadd_rn(__fadd_rn(__fdiv_rn(bt[i], v),
                                     xv[i] >= 0.0f ? chi : 0.0f),
                           -(xv[i] >= 0.0f ? 0.0f : chi));
      }
      if (c < d) store8(dx + (size_t)row * d + c, out);
    }
  }
}

constexpr int FWD_ROWS = 8;    // rows per block of the vector forward
constexpr int FWD_PASSES = 4;  // 256-element passes of a row held in flight

// f8, d a multiple of 8 and every source row 16-byte aligned: one warp per
// wire row; a lane holds 8 consecutive elements, so 4 lanes share a scale
// block; the payload goes out 8 bytes a lane and one lane in four writes
// the scale. An empty slot loads nothing and writes its zero payload and
// its 1.0 scales in 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(FWD_ROWS * 32)
pack_quant_kernel(const T* __restrict__ x, const int* __restrict__ tok,
                  uint8_t* __restrict__ q, float* __restrict__ sc, int R,
                  int n_src, int d, int d_pad) {
  constexpr int W = sizeof(T) / 2;  // 16-byte words per lane per pass
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * FWD_ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int t = tok[row];
  if (t >= n_src) __trap();  // an index out of range is a bug
  const int nb = d_pad / BLOCK;
  uint8_t* qr = q + (size_t)row * d_pad;
  float* sr = sc + (size_t)row * nb;
  if (t < 0) {
    for (int c = 16 * lane; c < d_pad; c += 512)
      *reinterpret_cast<uint4*>(qr + c) = make_uint4(0, 0, 0, 0);
    if (nb % 4 == 0) {  // the row's scales start 16-byte aligned
      for (int b = 4 * lane; b < nb; b += 128)
        *reinterpret_cast<float4*>(sr + b) = make_float4(1.f, 1.f, 1.f, 1.f);
    } else {
      for (int b = lane; b < nb; b += 32) sr[b] = 1.0f;
    }
    return;
  }
  const T* xr = x + (size_t)t * d;
  for (int base = 0; base < d_pad; base += 256 * FWD_PASSES) {
    uint4 xw[FWD_PASSES][W];
#pragma unroll
    for (int u = 0; u < FWD_PASSES; ++u) {
      const int c = base + 256 * u + 8 * lane;
#pragma unroll
      for (int k = 0; k < W; ++k)
        xw[u][k] = c < d ? reinterpret_cast<const uint4*>(xr + c)[k]
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < FWD_PASSES; ++u) {
      const int c = base + 256 * u + 8 * lane;
      if (base + 256 * u >= d_pad) break;  // the whole warp's pass lies past
      float v[8];
      unpack8<T>(xw[u], v);
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const float s = amax > 0.0f ? __fmul_rn(amax, F8_INV) : 1.0f;
      uint32_t w[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i / 4] |= static_cast<uint32_t>(f32_to_e4m3fn(__fdiv_rn(v[i], s)))
                    << (8 * (i % 4));
      if (c < d_pad) {
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
        if (lane % 4 == 0) sr[c / BLOCK] = s;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// f8 variant. x [n_src, d] f32 (bf16 = 0) or bf16 (bf16 = 1); tok int32
// [R]; q [R, d_pad] bytes; sc [R, d_pad / 32] f32. Launches on `stream`;
// returns cudaGetLastError() (0 = ok). Nothing is allocated here.
extern "C" int pack_quant_launch(const void* x, const void* tok, void* q,
                                 void* sc, int R, int n_src, int d,
                                 int d_pad, int bf16, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  if (R == 0) return 0;
  if (d_pad % BLOCK || d_pad < d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tok);
  uint8_t* qo = static_cast<uint8_t*>(q);
  float* so = static_cast<float*>(sc);
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(q) &&
                   aligned16(sc);
  const int blocks = (R + FWD_ROWS - 1) / FWD_ROWS;
  if (bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      pack_quant_kernel<__nv_bfloat16><<<blocks, FWD_ROWS * 32, 0, s>>>(
          xb, tk, qo, so, R, n_src, d, d_pad);
    else
      pack_quant_scalar_kernel<__nv_bfloat16><<<R, NT, 0, s>>>(
          xb, tk, qo, so, n_src, d, d_pad);
  } else {
    const float* xf = static_cast<const float*>(x);
    if (vec)
      pack_quant_kernel<float><<<blocks, FWD_ROWS * 32, 0, s>>>(
          xf, tk, qo, so, R, n_src, d, d_pad);
    else
      pack_quant_scalar_kernel<float><<<R, NT, 0, s>>>(xf, tk, qo, so, n_src,
                                                       d, d_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// cast variant. x as above (in_bf16); out [R, d] f32 (out_bf16 = 0) or
// bf16 (out_bf16 = 1).
extern "C" int pack_cast_launch(const void* x, const void* tok, void* out,
                                int R, int n_src, int d, int in_bf16,
                                int out_bf16, void* stream) {
  cudaGetLastError();
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tok);
  if (in_bf16 && out_bf16)
    pack_cast_kernel<__nv_bfloat16, __nv_bfloat16><<<R, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), tk,
        static_cast<__nv_bfloat16*>(out), n_src, d);
  else if (in_bf16)
    pack_cast_kernel<__nv_bfloat16, float><<<R, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), tk, static_cast<float*>(out),
        n_src, d);
  else if (out_bf16)
    pack_cast_kernel<float, __nv_bfloat16><<<R, NT, 0, s>>>(
        static_cast<const float*>(x), tk, static_cast<__nv_bfloat16*>(out),
        n_src, d);
  else
    pack_cast_kernel<float, float><<<R, NT, 0, s>>>(
        static_cast<const float*>(x), tk, static_cast<float*>(out), n_src, d);
  return static_cast<int>(cudaGetLastError());
}

// Backward of the f8 wire codec (and of its pack when tok is not null).
// x [n_src, d] f32 (bf16 = 0) or bf16 (bf16 = 1); tok int32 [R] or null
// (rows are x's own, R = n_src); g, dx [R, d] in x's type.
extern "C" int pack_quant_bwd_launch(const void* x, const void* tok,
                                     const void* g, void* dx, int R,
                                     int n_src, int d, int d_pad, int bf16,
                                     void* stream) {
  cudaGetLastError();
  if (R == 0) return 0;
  if (d_pad % BLOCK || d_pad < d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tk = static_cast<const int*>(tok);
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dx);
  const int blocks = (R + BWD_ROWS - 1) / BWD_ROWS;
  if (bf16) {
    using T = __nv_bfloat16;
    const T* xb = static_cast<const T*>(x);
    const T* gb = static_cast<const T*>(g);
    T* db = static_cast<T*>(dx);
    if (vec)
      pack_quant_bwd_kernel<T><<<blocks, BWD_ROWS * 32, 0, s>>>(
          xb, tk, gb, db, R, n_src, d);
    else
      pack_quant_bwd_scalar_kernel<T><<<R, NT, 0, s>>>(xb, tk, gb, db, n_src,
                                                       d, d_pad);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(g);
    float* df = static_cast<float*>(dx);
    if (vec)
      pack_quant_bwd_kernel<float><<<blocks, BWD_ROWS * 32, 0, s>>>(
          xf, tk, gf, df, R, n_src, d);
    else
      pack_quant_bwd_scalar_kernel<float><<<R, NT, 0, s>>>(xf, tk, gf, df,
                                                           n_src, d, d_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
