// Grouped gated expert FFN for Hopper (sm_90a), plain C interface.
//
//   out[e] = (act(h[e] @ w_gate[e]) * (h[e] @ w_up[e])) @ w_down[e]
//
// Replaces the Pallas kernel repro/kernels/expert_ffn.py::_ffn_kernel (K1).
// h is [E, R, d], the weights [Ew, d, F] / [Ew, F, d]. Two routes, chosen by
// the wrapper (kernels/expert_ffn.py::route) and entered through two C
// functions; both are two kernels on the caller's stream, gate/up into a
// scratch hidden [E, R, F], then down, and both mask ragged R (any R >= 1).
// Both take an optional group map widx [E] (common.cuh): row group e reads
// weight group widx[e], and -1 is an idle group, left out of the tile walk
// and zeroed by zero_idle_groups. The expert-parallel path's replica lanes
// use it: a lane runs an intra-node peer's expert from the one f32 master
// stack, so no weight stack is concatenated or cast per step. A null map is
// the identity and keeps the code path and the bits of a launch without.
//
// 1. The tensor-core route (expert_ffn_wgmma_launch): bf16 h and bf16
//    weights, d and F multiples of 64. bf16 products summed in f32 by
//    wgmma; the hidden act(gt) * up is rounded to bf16 (it is the down
//    product's A operand), the output too.
//      - ffn_wgmma_kernel<GATED> is one GEMM shape for both halves, on
//        output tiles of (128 columns of N, 128 rows of R, expert): one
//        block of 288 threads per SM (two consumer warpgroups of 64 rows
//        and one producer warp) walks the tiles, N fastest, so the ring
//        fills the next tile's stages while a tile's epilogue runs. gate/up: K = d, N = F, two B operands (w_gate, w_up) and two
//        m64n128 f32 accumulators per warpgroup, act(g) * u in the epilogue.
//        down: K = F, N = d, one B operand (w_down).
//      - The producer's one thread brings each 64-deep stage into a ring of
//        mbarrier-guarded stages by TMA through 3-D tensor maps over
//        [E, rows, cols] (the 128-byte swizzle; a box is 64 columns): A as
//        one [128 x 64] box, K-major; each B as two [64 x 64] boxes of N
//        side by side, MN-major (N contiguous in w_gate, w_up, w_down). Rows
//        past R, and columns past N, come back as zeros, never from the
//        next expert. "full" barriers count the bytes in, "empty" ones the
//        consumer warps out.
//      - Each consumer warpgroup issues wgmma m64n128k16 per 16 of K, B
//        with the transpose bit and a live leading-byte offset (the 8 KB
//        step from one 64-column box to the next), keeps one stage's
//        products in flight (wait_group 1) and frees the stage before it.
//        A warpgroup whose 64 rows all lie past R issues nothing (decode).
//      - No atomics and no split over K: a launch repeats bit for bit.
// 2. The FMA route (expert_ffn_launch): everything else (f32 h, which
//    keeps the f32 contract, or other widths): h in f32 or bf16, weights
//    in f32 or bf16, independently, every product and sum an f32 FMA (no
//    TF32, no tensor cores), the hidden f32, the output cast to h's type.
//    One block of 256 threads per (64-column tile, R tile, expert), each
//    thread a TMx4 micro-tile strided by 16 so shared-memory reads are
//    conflict-free and global stores coalesce. Two tilings: TM=4 (64 rows,
//    16-deep slabs) for prefill, and TM=1 (16 rows, 32-deep slabs) for
//    R <= 16, where a 64-row tile would spend 7/8 of its FMAs on padding.
//
// What bounds it on an H100 (moe-gpt2: 16 experts, d 768, F 3072):
//   * decode (R = 8 rows per expert): weight bytes. bf16 weights are
//     226.5 MB per layer, about 68 us at 3.35 TB/s; 1.8 GFLOP. Every
//     weight tile is read once (one row tile), 384 gate/up blocks keep the
//     card's 132 SMs streaming.
//   * prefill (R = 256) and train (R = 2048): operations at the bf16
//     tensor-core rate, 58 and 464 GFLOP per layer (0.06 and 0.47 ms at
//     989 TFLOP/s) against 239 and 327 MB of h, weights and output. The
//     hidden's round trip through device memory (bf16, 403 MB at the train
//     shape, ~0.12 ms) is what fusing the two halves would save.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 64;   // columns of the output tile
constexpr int TN = 4;    // columns per thread (strided by 16)
constexpr int NT = 256;  // threads per block: 16 x 16
// TM: rows per thread (strided by 16), so 16 * TM rows per tile;
// BK: depth of one shared-memory slab. Both are template parameters.

template <int TM, int BK, typename TH, typename TW>
__global__ void __launch_bounds__(NT)
gate_up_kernel(const TH* __restrict__ h, const TW* __restrict__ wu,
               const TW* __restrict__ wg, float* __restrict__ hid,
               const int* __restrict__ widx, int R, int d, int F, int act) {
  constexpr int BM = 16 * TM;
  __shared__ float sA[BK][BM + 1];  // h slab, transposed; +1 breaks conflicts
  __shared__ float sU[BK][BN];
  __shared__ float sG[BK][BN];
  const int e = blockIdx.z;
  const int we = widx ? widx[e] : e;  // the weights group e reads
  if (we < 0) return;                 // idle: its hidden is never read
  const int r0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TH* he = h + (size_t)e * R * d;
  const TW* ue = wu + (size_t)we * d * F;
  const TW* ge = wg + (size_t)we * d * F;
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
            TH* __restrict__ out, const int* __restrict__ widx, int R, int d,
            int F) {
  constexpr int BM = 16 * TM;
  __shared__ float sA[BK][BM + 1];
  __shared__ float sB[BK][BN];
  const int e = blockIdx.z;
  const int we = widx ? widx[e] : e;
  if (we < 0) return;   // idle: zero_idle_groups writes its output
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* he = hid + (size_t)e * R * F;
  const TW* de = wd + (size_t)we * F * d;
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
                  const void* wd, void* out, float* hid, const int* widx,
                  int E, int R, int d, int F, int act, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 block(NT);
  const dim3 g1((F + BN - 1) / BN, (R + BM - 1) / BM, E);
  const dim3 g2((d + BN - 1) / BN, (R + BM - 1) / BM, E);
  gate_up_kernel<TM, BK, TH, TW><<<g1, block, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(wu),
      static_cast<const TW*>(wg), hid, widx, R, d, F, act);
  down_kernel<TM, BK, TH, TW><<<g2, block, 0, stream>>>(
      hid, static_cast<const TW*>(wd), static_cast<TH*>(out), widx, R, d, F);
  if (widx) launch_zero_idle<TH>(widx, out, E, (size_t)R * d, stream);
}

template <typename TH, typename TW>
void launch(const void* h, const void* wu, const void* wg, const void* wd,
            void* out, float* hid, const int* widx, int E, int R, int d,
            int F, int act, cudaStream_t stream) {
  if (R <= 16)
    launch_tiled<1, 32, TH, TW>(h, wu, wg, wd, out, hid, widx, E, R, d, F,
                                act, stream);
  else
    launch_tiled<4, 16, TH, TW>(h, wu, wg, wd, out, hid, widx, E, R, d, F,
                                act, stream);
}


// ---------------------------------------------------------------------------
// the tensor-core route (bf16 h and weights, d and F multiples of 64)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;      // rows per block: two warpgroups of 64
constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // depth of a stage: one 128-byte swizzle row
constexpr int BOX_N = 64;    // columns of one B box (one swizzle row)
constexpr int NT = 288;      // 2 consumer warpgroups + 1 producer warp
constexpr int CONSUMER_WARPS = 8;
constexpr int ROW_B = 128;   // bytes of one swizzled row
constexpr int A_BYTES = BM * BK * 2;        // 16 KB
constexpr int BOX_B_BYTES = BK * BOX_N * 2; // 8 KB
constexpr int B_BYTES = BK * BN * 2;        // 16 KB: two boxes

template <bool GATED, int STAGES>
struct Smem {
  static constexpr int STAGE = A_BYTES + (GATED ? 2 : 1) * B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  // full[STAGES], empty[STAGES]; 1024 bytes of slack to align the base
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
};

// GATED: out = hidden [E, R, N = F] = bf16(act(A @ B0) * (A @ B1)), A = h
//        [E, R, K = d], B0 = w_gate, B1 = w_up [E, K, N];
// else:  out [E, R, N = d] = bf16(A @ B0), A = hidden [E, R, K = F], B0 =
//        w_down [E, K, N].
template <bool GATED, int STAGES>
__global__ void __launch_bounds__(NT, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb0,
                 const __grid_constant__ CUtensorMap tb1,
                 __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ widx, int E, int R, int K, int N,
                 int act) {
  using L = Smem<GATED, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the base to them, so
  // the descriptors' base offset is 0
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  // output tiles, N fastest, then R, then the live group; block b takes
  // tiles b, b + gridDim.x, ... and the ring runs on across them. A map
  // leaves idle groups out of the walk (zero_idle_groups writes them).
  const int n_nt = (N + BN - 1) / BN, n_rt = (R + BM - 1) / BM;
  const int n_tiles = n_nt * n_rt * (widx ? map_live(widx, E) : E);
  const int nk = K / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: one thread issues every copy of the block
    if (lane == 0) {
      int t = 0;   // stages filled so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % n_nt) * BN;
        const int r0 = (tile / n_nt % n_rt) * BM;
        const int ec = tile / (n_nt * n_rt);
        const int e = widx ? map_nth_live(widx, E, ec) : ec;
        const int we = widx ? widx[e] : e;   // B's group: the weights
        for (int kt = 0; kt < nk; ++kt, ++t) {
          const int s = t % STAGES;
          mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, L::STAGE);
          const uint32_t st = base + s * L::STAGE;
          const uint32_t full = bar_full + 8 * s;
          tma_load_3d(st, &ta, full, kt * BK, r0, e);
#pragma unroll
          for (int j = 0; j < BN / BOX_N; ++j) {
            tma_load_3d(st + A_BYTES + j * BOX_B_BYTES, &tb0, full,
                        n0 + j * BOX_N, kt * BK, we);
            if constexpr (GATED)
              tma_load_3d(st + A_BYTES + B_BYTES + j * BOX_B_BYTES, &tb1,
                          full, n0 + j * BOX_N, kt * BK, we);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows rw0 .. rw0 + 63 of a tile; this
  // thread rows row0 and row0 + 8, and in each 8-column group the columns
  // c8, c8 + 1
  const int wg = warp / 4;
  const int c8 = 2 * (lane % 4);
  int t = 0;   // stages consumed so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_nt) * BN;
    const int r0 = (tile / n_nt % n_rt) * BM;
    const int ec = tile / (n_nt * n_rt);
    const int e = widx ? map_nth_live(widx, E, ec) : ec;
    const int rw0 = r0 + wg * 64;
    const bool live = rw0 < R;   // uniform over the warpgroup
    float acc0[64], acc1[64];    // gate and up (GATED), or down and unused
#pragma unroll
    for (int j = 0; j < 64; ++j) acc0[j] = acc1[j] = 0.0f;

    for (int kt = 0; kt < nk; ++kt, ++t) {
      const int s = t % STAGES;
      const uint32_t st = base + s * L::STAGE;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 32 bytes of K inside each row; B: 16 rows of K, 2048 bytes
          const uint64_t da = desc_sw128(st + wg * 64 * ROW_B + kk * 32);
          const uint32_t b = st + A_BYTES + kk * 16 * ROW_B;
          wgmma_m64n128k16_ss<1>(acc0, da, desc_sw128(b, BOX_B_BYTES), 1);
          if constexpr (GATED)
            wgmma_m64n128k16_ss<1>(acc1, da,
                                   desc_sw128(b + B_BYTES, BOX_B_BYTES), 1);
        }
        wgmma_commit();
        wgmma_wait1();   // the previous stage's products have landed
      }
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % STAGES));
      }
    }
    if (live) {
      wgmma_wait0();
      fence_regs(acc0);
      if constexpr (GATED) fence_regs(acc1);
    }
    // the tile's last stage is free: the producer fills the next tile's
    // stages while this one's epilogue runs
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % STAGES));
    if (!live) continue;

    const int row0 = rw0 + 16 * (warp % 4) + lane / 4;
    __nv_bfloat16* o0 = out + ((size_t)e * R + row0) * N + n0 + c8;
    __nv_bfloat16* o1 = o0 + (size_t)8 * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // registers 4i, 4i+1: row0; 4i+2, 4i+3: row0 + 8
      const int col = n0 + 8 * i + c8;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = GATED ? act_fn(acc0[4 * i + j], act) * acc1[4 * i + j]
                     : acc0[4 * i + j];
      if (col < N) {
        if (row0 < R)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * i) =
              __floats2bfloat162_rn(v[0], v[1]);
        if (row0 + 8 < R)
          *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * i) =
              __floats2bfloat162_rn(v[2], v[3]);
      }
    }
  }
}

// One block per SM (at most one per tile), each walking its tiles.
template <bool GATED, int STAGES>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb0,
                        const CUtensorMap& tb1, void* out, const int* widx,
                        int E, int R, int K, int N, int act, int n_sm,
                        cudaStream_t stream) {
  constexpr int bytes = Smem<GATED, STAGES>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_wgmma_kernel<GATED, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((N + BN - 1) / BN) *
                          ((R + BM - 1) / BM) * E;
  const int grid = static_cast<int>(tiles < n_sm ? tiles : n_sm);
  ffn_wgmma_kernel<GATED, STAGES><<<grid, NT, bytes, stream>>>(
      ta, tb0, tb1, static_cast<__nv_bfloat16*>(out), widx, E, R, K, N, act);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// h_bf16 / w_bf16 select bf16 (1) or f32 (0) storage; act 0 = silu, 1 = gelu.
// h is [E, R, d] (E row groups), the weights [Ew, ...]. widx: null (the
// identity, Ew = E) or int32 [E] on the device, the weight group each row
// group reads, in [0, Ew), or -1 for an idle group (zero output, no
// products). `hid` is f32 scratch of E * R * F elements; nothing is
// allocated here.
extern "C" int expert_ffn_launch(const void* h, const void* wu, const void* wg,
                                 const void* wd, void* out, void* hid,
                                 const void* widx, int E, int Ew, int R, int d,
                                 int F, int h_bf16, int w_bf16, int act,
                                 void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  (void)Ew;            // the FMA kernels index the weights by pointer
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(hid);
  const int* wi = static_cast<const int*>(widx);
  if (h_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(h, wu, wg, wd, out, hf, wi, E, R, d,
                                         F, act, s);
  else if (h_bf16)
    launch<__nv_bfloat16, float>(h, wu, wg, wd, out, hf, wi, E, R, d, F, act,
                                 s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(h, wu, wg, wd, out, hf, wi, E, R, d, F, act,
                                 s);
  else
    launch<float, float>(h, wu, wg, wd, out, hf, wi, E, R, d, F, act, s);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: launches both kernels on `stream`; returns a
// cudaError_t (0 = ok). h [E, R, d], w_up / w_gate [Ew, d, F], w_down
// [Ew, F, d], out [E, R, d] and the scratch hidden `hid` [E, R, F] all
// bf16, contiguous and 16-byte aligned (the wrapper sees to it); d and F
// multiples of 64; widx as expert_ffn_launch's (the weights' group is the
// third TMA coordinate of B); act 0 = silu, 1 = gelu. Nothing is
// allocated here. A tensor map that fails to encode returns
// cudaErrorInvalidValue, a driver without cuTensorMapEncodeTiled
// cudaErrorNotSupported.
extern "C" int expert_ffn_wgmma_launch(const void* h, const void* wu,
                                       const void* wg, const void* wd,
                                       void* out, void* hid, const void* widx,
                                       int E, int Ew, int R, int d, int F,
                                       int act, void* stream) {
  using namespace tc;
  cudaGetLastError();  // start from a clean slate; report only our launches
  if (d % BK != 0 || F % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mh, mwg, mwu, mhid, mwd;
  if (!tma_map_bf16_3d(fn, &mh, h, E, R, d, BM) ||
      !tma_map_bf16_3d(fn, &mwg, wg, Ew, d, F, BK) ||
      !tma_map_bf16_3d(fn, &mwu, wu, Ew, d, F, BK) ||
      !tma_map_bf16_3d(fn, &mhid, hid, E, R, F, BM) ||
      !tma_map_bf16_3d(fn, &mwd, wd, Ew, F, d, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wi = static_cast<const int*>(widx);
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<true, 4>(mh, mwg, mwu, hid, wi, E, R, d, F, act, n_sm, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<false, 6>(mhid, mwd, mwd, out, wi, E, R, F, d, 0, n_sm, s);
  if (e != cudaSuccess || wi == nullptr) return static_cast<int>(e);
  launch_zero_idle<__nv_bfloat16>(wi, out, E, (size_t)R * d, s);
  return static_cast<int>(cudaGetLastError());
}
