// Streaming-softmax attention for Hopper (sm_90a), plain C interface:
// out[b, i, h] = softmax_j(q_i . k_j * scale | mask(i, j)) @ v, with the
// mask by position: causal (j <= i) and/or a sliding window (i - j < W).
// Queries and keys may differ in number (Sq, Sk) only without either
// mask: cross-attention, where every key is live (the wrapper refuses a
// causal or windowed launch at Sq != Sk). Sq is the queries' length, Sk
// the keys' and values'; at Sq == Sk the two read the same.
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py::_flash_kernel
// (K5), the attention core of every decoder's batched prefill on the card. Its arithmetic is
// the Pallas kernel's: f32 scores and running (m, l, acc); masked scores
// set to NEG = -1e30; m clamped at -0.5e30 so a row with nothing live yet
// gives exp(...) = 0, not NaN; masked p set to 0; out = acc / max(l, 1e-30).
// Both kernels walk only the key tiles of the band, from
// max(0, q0 - W + 1) to the causal end (all key tiles when not causal):
// the Pallas kernel's early-out of fully masked tiles as a loop bound.
// GQA: head h reads KV head h / (H / KV) in place, never expanded.
//
// Head dims: any multiple of 4 up to 256 (the Pallas kernel takes any hd;
// the attention decoders the port serves use 64, 128, 160 and 256).
//
// What bounds it on an H100: operations. At hymba's prefill (B=4, S=2048,
// 25 heads of 64, window 1024) about 1.57 M live (q, k) pairs per (b, h),
// 4 x hd FLOPs each: ~40 GFLOP per layer against ~50 MB of bf16 q, k, v
// and out, so the least time is the bf16 tensor-core rate's (~0.04 ms).
//
// Dispatch, by dtype and head dim (flash_attention_launch):
//   * bf16 with hd in {64, 128, 160, 256}: flash_wgmma_kernel, on the
//     tensor cores. One block per (b, h, 128-query tile): two consumer
//     warpgroups of 64 query rows each and a producer (one warp; at hd 256
//     a whole warpgroup, which gives its registers to the consumers by
//     setmaxnreg).
//       - The producer's one thread brings the q tile and then the band's
//         k and v tiles (BKT keys: 128 at hd <= 128, 64 above) into shared
//         memory by TMA, through 4-D tensor maps over [B, S, heads, hd]
//         with boxes of (64, 1, rows, 1) and the 128-byte swizzle (a
//         64-wide bf16 row is one 128-byte atom; hd = 128 is two boxes side
//         by side, 256 four). At hd 160 the third box runs past the
//         tensor's 160 columns: TMA fills columns 160..191 with zeros,
//         which add nothing to Q K^T, and the store writes only the 160
//         real columns of O. Rows past S come back as zeros, never from
//         the next sequence. k and v go into a ring of STAGES stages;
//         "full" mbarriers count the bytes in, "empty" mbarriers count the
//         consumer warps out, so tile j+1 loads while tile j computes.
//         Shared memory: q 128 x 64 x NA bf16 (NA = ceil(hd / 64) atoms)
//         and 2 x STAGES tiles of BKT x 64 x NA: 192 KB at hd 256 (2
//         stages of 64 keys), 192 KB at hd 160 (3 stages of 64), of the
//         227 KB a block may have.
//       - Each consumer warpgroup computes S = Q K^T with wgmma m64nBKTk16
//         (q and k both K-major from shared memory: k's natural [BKT, hd]
//         rows), then the online softmax on the accumulator in registers
//         (row max and row sum over the quad of lanes that share a row;
//         exp2 on scores pre-scaled by log2(e), so m, NEG and the clamp
//         are in log2 units), then O += P V with wgmma m64n64k16 per 64
//         columns of hd: P is the f32 tile rescaled and rounded to bf16
//         in registers as the A operand (the m64nN accumulator fragment is
//         the A fragment of the next product), v the MN-major B operand.
//         l sums the f32 p before the rounding. A thread holds 32 x NA
//         f32 of O: 128 at hd 256, hence 64-key tiles (32 scores) and the
//         consumers' 232 registers there.
//       - The per-element mask runs only on tiles that cross the diagonal,
//         the window's edge or S; interior tiles skip it.
//       - No atomics and no split over keys: a launch repeats bit for bit.
//     Blocks go out heaviest query tile first (the band is shorter near
//     the start of the sequence).
//   * everything else (f32 at any hd, which keeps the f32 contract that
//     TF32 would break; bf16 at other hd): flash_kernel, plain f32 FMAs.
//     One block of 256 threads per (b, h, 64-query tile); tiles of q, k, v
//     (f32 in shared memory, rows padded by one word) and of p; four
//     threads per query row, each holding 16 scores of a key tile and
//     hd / 4 columns of acc in registers (16, 32 or 64: at hd 256, 64
//     registers of acc and 209 KB of shared memory, one block an SM);
//     row max and sum over the four with xor shuffles; ragged S is masked.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float M_FLOOR = -0.5e30f;

// ---------------------------------------------------------------------------
// the FMA kernel (f32, and bf16 at head dims the wgmma kernel does not take)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 4 per query row
constexpr int KPT = BK / 4;  // scores per thread per key tile

__host__ __device__ constexpr int smem_floats(int hd) {
  return 3 * BQ * (hd + 1) + BQ * (BK + 1);
}

// CPT = columns of acc per thread (hd / 4 rounded up to 16, 32 or 64).
template <typename T, int CPT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                 // [BQ][ld]
  float* Ks = Qs + BQ * ld;         // [BK][ld]
  float* Vs = Ks + BK * ld;         // [BK][ld]
  float* Ps = Vs + BK * ld;         // [BQ][BK + 1]

  const int n_qt = (Sq + BQ - 1) / BQ;
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
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * hd;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * hd;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * hd;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int rr = i / hd, dd = i % hd;
    Qs[rr * ld + dd] =
        q0 + rr < Sq ? to_f32(qb[(size_t)(q0 + rr) * q_row + dd]) : 0.0f;
  }

  // the band of key tiles this query tile can see (causal: Sq == Sk)
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int hi = causal ? (min(q0 + BQ, Sq) - 1) / BK : (Sk - 1) / BK;

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
      const bool ok = k0 + rr < Sk;
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
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      live[j] = ok;
      s[j] = ok ? s[j] * scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(m, mx), M_FLOOR);
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

  if (qpos < Sq) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * Sq + qpos) * q_row + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (j < ncol) o[g + 4 * j] = from_f32<T>(acc[j] * inv_l);
  }
}

template <typename T, int CPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  const int bytes = smem_floats(hd) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + BQ - 1) / BQ;
  flash_kernel<T, CPT><<<B * H * n_qt, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, hd,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16, hd 64, 128, 160 or 256): wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;       // queries per block: two warpgroups of 64
constexpr int ATOM = 64;      // bf16 columns in one 128-byte swizzle row
constexpr int ROW_B = 128;    // bytes of one swizzled row
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)

// d[32] += A[64 x 16] B[16 x 64], A bf16 in registers (the m64nNk16 A
// fragment), B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Shared-memory layout of one block: the q tile, STAGES k tiles, STAGES v
// tiles (each NA swizzle atoms of 64 columns side by side), then the
// mbarriers.
template <int HD, int BKT, int STAGES>
struct Smem {
  static constexpr int NA = (HD + ATOM - 1) / ATOM;  // swizzle atoms
  static constexpr int Q_BYTES = BQ * NA * ATOM * 2;
  static constexpr int TILE_BYTES = BKT * NA * ATOM * 2;  // one k or v tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // q, full[STAGES], empty[STAGES]; 1024 bytes of slack to align the base
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// Registers per thread after setmaxnreg when the producer is a whole
// warpgroup (384 threads): 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int BKT>
__device__ __forceinline__ void qk_step(float (&s)[BKT / 2], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (BKT == 128)
    wgmma_m64n128k16_ss<0>(s, da, db, accumulate);
  else
    wgmma_m64n64k16_ss<0>(s, da, db, accumulate);
}

// HD: the head dim (64, 128, 160 or 256); BKT: keys per k / v tile;
// WG_PRODUCER: the producer is a warpgroup that hands its registers to the
// consumers (384 threads), else one warp (288 threads).
template <int HD, int BKT, int STAGES, bool WG_PRODUCER>
__global__ void __launch_bounds__(WG_PRODUCER ? 384 : 288, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk,
                   int H, int KV, float scale_log2, int causal, int window) {
  using L = Smem<HD, BKT, STAGES>;
  constexpr int NA = L::NA;
  constexpr int NS = BKT / 2;       // scores of a row pair per thread
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the base to them, so
  // the descriptors' base offset is 0
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - blockIdx.x / (B * H);   // heaviest tiles first
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int lo = window > 0 ? max(0, q0 - window + 1) / BKT : 0;
  const int hi = causal ? (min(q0 + BQ, Sq) - 1) / BKT : (Sk - 1) / BKT;
  const int n_tiles = hi - lo + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    if constexpr (WG_PRODUCER)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    // producer: one thread issues every copy of the block
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(sq + a * BQ * ROW_B, &tq, bar_q, a * ATOM, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::TILE_BYTES);
        const int k0 = (lo + t) * BKT;
        const uint32_t dk = base + L::K_OFF + s * L::TILE_BYTES;
        const uint32_t dv = base + L::V_OFF + s * L::TILE_BYTES;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(dk + a * BKT * ROW_B, &tk, bar_full + 8 * s, a * ATOM,
                      kvh, k0, b);
          tma_load_4d(dv + a * BKT * ROW_B, &tv, bar_full + 8 * s, a * ATOM,
                      kvh, k0, b);
        }
      }
    }
    return;
  }
  if constexpr (WG_PRODUCER)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));

  // consumers: warpgroup wg owns query rows qw0 .. qw0 + 63; this thread
  // rows r0 and r0 + 8, and in each 8-column group of a product the
  // columns c8 and c8 + 1
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + 16 * (warp % 4) + lane / 4;
  const int c8 = 2 * (lane % 4);
  const uint32_t sq_wg = sq + wg * 64 * ROW_B;

  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[a][j] = 0.0f;
  float s[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int k0 = (lo + t) * BKT;
    const uint32_t sk = base + L::K_OFF + st * L::TILE_BYTES;
    const uint32_t sv = base + L::V_OFF + st * L::TILE_BYTES;
    mbar_wait(bar_full + 8 * st, (t / STAGES) & 1);

    // S = Q K^T: ceil(hd / 16) k-steps of 32 bytes inside the 128-byte
    // atoms (at hd 160 the last atom's upper half, zeros, is skipped)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      qk_step<BKT>(s, desc_sw128(sq_wg + (kk / 4) * BQ * ROW_B + off),
                   desc_sw128(sk + (kk / 4) * BKT * ROW_B + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] *= scale_log2;
    const bool edge = k0 + BKT > Sk || (causal && k0 + BKT - 1 > qw0) ||
                      (window > 0 && qw0 + 63 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int kpos = k0 + 8 * (j / 4) + c8 + (j & 1);
        const int qpos = r0 + 8 * ((j / 2) & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) s[j] = NEG;
      }
    }

    // online softmax; registers 4i, 4i+1 are row r0, 4i+2, 4i+3 row r0+8
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(fmaxf(m0, mx0), M_FLOOR);
    const float mn1 = fmaxf(fmaxf(m1, mx1), M_FLOOR);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      // a masked score is NEG <= mn - 0.5e30, so its p is exactly 0
      s[4 * i] = ex2(s[4 * i] - mn0);
      s[4 * i + 1] = ex2(s[4 * i + 1] - mn0);
      s[4 * i + 2] = ex2(s[4 * i + 2] - mn1);
      s[4 * i + 3] = ex2(s[4 * i + 3] - mn1);
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
    // this thread's share of the row sums; the quad adds them at the end
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[a][4 * i] *= alpha0;
        o[a][4 * i + 1] *= alpha0;
        o[a][4 * i + 2] *= alpha1;
        o[a][4 * i + 3] *= alpha1;
      }
    uint32_t p[NS / 2];
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

    // O += P V: BKT / 16 k-steps of 16 keys (2048 bytes of v) per 64 hd
    // columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_m64n64k16_rs(o[a], p + 4 * kk,
                           desc_sw128(sv + a * BKT * ROW_B + kk * 16 * ROW_B));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t row = (size_t)H * HD;
  __nv_bfloat16* o0 = out + ((size_t)b * Sq + r0) * row + (size_t)h * HD + c8;
  __nv_bfloat16* o1 = o0 + 8 * row;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = a * ATOM + 8 * i;
      // at hd 160 the last atom's columns 160..191 are TMA's zero fill:
      // never stored (col is even, so col < HD covers col + 1 too)
      if (col >= HD) continue;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(o[a][4 * i] / d0, o[a][4 * i + 1] / d0);
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(o[a][4 * i + 2] / d1,
                                  o[a][4 * i + 3] / d1);
    }
}

// [B, S, heads, hd] bf16, contiguous, boxes of (64, 1, rows, 1); columns
// past hd, and rows past S (a ragged last tile), come back as zeros: S is
// a dimension of the map of its own, so a box never reads into the next
// batch row. q's map spans Sq positions, k's and v's Sk.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S,
            int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {ATOM, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BKT, int STAGES, bool WG_PRODUCER>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!encode(fn, &mq, q, B, Sq, H, HD, BQ) ||
      !encode(fn, &mk, k, B, Sk, KV, HD, BKT) ||
      !encode(fn, &mv, v, B, Sk, KV, HD, BKT))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Smem<HD, BKT, STAGES>::BYTES;
  static_assert(bytes <= 232448, "over the 227 KB a block may have");
  auto kernel = flash_wgmma_kernel<HD, BKT, STAGES, WG_PRODUCER>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (Sq + BQ - 1) / BQ;
  kernel<<<B * H * n_qt, WG_PRODUCER ? 384 : 288, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, KV,
      scale * LOG2E, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 = ok).
// q, out [B, Sq, H, hd]; k, v [B, Sk, KV, hd], Sq == Sk unless neither
// causal nor windowed (cudaErrorInvalidValue otherwise), both >= 1,
// contiguous, all f32 (bf16 =
// 0) or all bf16 (bf16 = 1); H % KV == 0; hd % 4 == 0 and hd <= 256; for
// bf16 at hd 64, 128, 160 or 256 (the tensor-core kernel) every pointer
// 16-byte aligned (the wrapper sees to both); window <= 0 means none.
// Nothing is allocated here. A tensor map that fails to encode returns
// cudaErrorInvalidValue, a driver without cuTensorMapEncodeTiled
// cudaErrorNotSupported.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 4 != 0 || hd > 256 || H % KV != 0 || Sq < 1 || Sk < 1 ||
      (Sq != Sk && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (hd == 64)
      return tc::launch<64, 128, 3, false>(q, k, v, out, B, Sq, Sk, H, KV,
                                           scale, causal, window, s);
    if (hd == 128)
      return tc::launch<128, 128, 2, false>(q, k, v, out, B, Sq, Sk, H, KV,
                                            scale, causal, window, s);
    if (hd == 160)
      return tc::launch<160, 64, 3, false>(q, k, v, out, B, Sq, Sk, H, KV,
                                           scale, causal, window, s);
    if (hd == 256)
      return tc::launch<256, 64, 2, true>(q, k, v, out, B, Sq, Sk, H, KV,
                                          scale, causal, window, s);
    if (hd < 64)
      return launch<__nv_bfloat16, 16>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                       scale, causal, window, s);
    if (hd <= 128)
      return launch<__nv_bfloat16, 32>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                       scale, causal, window, s);
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                     scale, causal, window, s);
  }
  if (hd <= 64)
    return launch<float, 16>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale,
                             causal, window, s);
  if (hd <= 128)
    return launch<float, 32>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale,
                             causal, window, s);
  return launch<float, 64>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal,
                           window, s);
}
