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
// the port's own, so that training runs through K1. h and dy are [E, R, d],
// the weights [E, d, F] / [E, F, d]; the weight gradients are f32 (AdamW's
// masters are f32) and dh is in h's type. Ragged R is masked. Nothing is
// carried between blocks and nothing is added atomically, so a run repeats
// bit for bit. Two routes, chosen by the wrapper
// (kernels/expert_ffn.py::bwd_route, the forward's rule), each a sequence
// of kernels on the caller's stream in three steps: hidden (recompute gt
// and up, form dhh; write P = a * up, DU = dup, DG = dgt to scratch
// [E, R, F]), then the weight gradients, then dh.
//
// 1. The tensor-core route (expert_ffn_bwd_wgmma_launch): bf16 h and dy,
//    d and F multiples of 64. Every product is bf16 x bf16 summed in f32 by
//    wgmma. bf16 alone would miss the f32 plain version by more than the
//    5e-2 the port holds K1 to: at moe-gpt2's train shape one bf16 rounding
//    of the weights, or of P, DU and DG, moves a weight gradient's entries
//    near zero by up to ~0.5. So each of those operands is carried as a pair
//    of bf16 terms, hi = bf16(x) and lo = bf16(x - hi), which hold x to 16
//    bits, and a product with it is two products into one accumulator
//    (h and dy are bf16 already and exact):
//      - hidden: dhh from dy against w_down's hi and lo (two products,
//        kept in f32 scratch); then gt and up from h against w_gate's and
//        w_up's hi and lo (four products), whose epilogue forms P, DU and
//        DG in f32 and stores each as its hi and lo in bf16 scratch
//        (6 x [E, R, F]);
//      - wgrad: dWu = h^T (DU hi + lo), dWg = h^T (DG hi + lo), dWd =
//        (P hi + lo)^T dy, reduced over R inside the block (six products);
//      - dh = DU hi W_up^T + DG hi W_gate^T against the weights' hi and lo
//        (four products; DU's and DG's lo terms move dh by less than its
//        own bf16 rounding).
//    bf16 weights passed in are exact: their lo terms are skipped (split =
//    0). The six launches (dhh, gt/up, three weight gradients, dh) are
//    instances of one persistent, warp-specialised kernel
//    (bwd_wgmma_kernel<Policy>): one block of 384 threads per SM (two
//    consumer warpgroups of 64 output rows, one producer warpgroup that
//    hands its registers to them by setmaxnreg) walks output tiles of
//    128 x 128; the producer's one thread fills a ring of
//    mbarrier-guarded 64-deep stages by TMA through 3-D tensor maps over
//    [E, rows, cols] (the 128-byte swizzle; rows past R load as zeros,
//    never the next expert's); each consumer warpgroup issues one wgmma
//    m64n128k16 per 16 of K and operand pair into f32 accumulators (two in
//    the gt/up kernel), keeps one stage in flight and frees the stage
//    before it. Operand layouts: h, dy, DU, DG as A are K-major; h and P as
//    wgrad's A are MN-major (the transpose bit on A); w_gate, w_up, DU, DG,
//    dy as B are MN-major (as in the forward); w_down^T (dhh) and w_up^T,
//    w_gate^T (dh) are K-major B, the weights' own rows.
//    Both routes take the forward's group map widx (common.cuh): dhh,
//    gt/up and dh read row group e's weights at widx[e] (idle groups are
//    left out of the walk, their dh zeroed), and a weight gradient runs K
//    over the rows of every group that reads that weight, ascending, into
//    one accumulator: the replica lane's rows fold into the owner's sum
//    with no atomics and no [E, ...] copy of the gradients.
// 2. The FMA route (expert_ffn_bwd_launch): everything else (f32 h, which
//    keeps the f32 contract, or other widths), h in f32 or bf16, weights in
//    f32 or bf16, every product an f32 FMA (no TF32), f32 scratch. One block
//    of 256 threads per 64x64 output tile, each thread a 4x4 micro-tile
//    strided by 16:
//      - hidden: one block per (F tile, R tile, expert), three
//        accumulators over d from shared-memory slabs;
//      - wgrad: one block per (output tile, product, expert), A^T @ B over
//        all R rows inside the block;
//      - dh: one block per (d tile, R tile, expert), over F.
//
// What bounds it on an H100: operations. The backward is 8 matrix products
// of the forward's size (two recomputed, dhh, three weight gradients, two
// for dh): at moe-gpt2's train width ([16, 2048, 768] x 3072) 1.24 TFLOP,
// 1.25 ms at the bf16 tensor-core rate (18.5 ms at the 67 TFLOP/s f32
// rate). The tensor-core route issues 16 products (2.47 TFLOP, 2.50 ms)
// for its f32-like sums, and moves ~4.7 GB (h, dy, the weights' two
// terms, the bf16 planes and dhh written and read, f32 weight gradients,
// dh): ~1.4 ms at 3.35 TB/s. On an H100 80GB HBM3 at 700 W it takes
// 4.84 ms there, the gt/up launch with its epilogue 2.0 ms of it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
              float* __restrict__ DU, float* __restrict__ DG,
              const int* __restrict__ widx, int R, int d, int F, int act) {
  __shared__ float sH[BK][BM + 1];
  __shared__ float sY[BK][BM + 1];
  __shared__ float sU[BK][BN];
  __shared__ float sG[BK][BN];
  __shared__ float sD[BK][BN];
  const int e = blockIdx.z;
  const int we = widx ? widx[e] : e;   // the weights group e reads
  if (we < 0) return;                  // idle: no weight takes its rows
  const int r0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TH* he = h + (size_t)e * R * d;
  const TH* ye = dy + (size_t)e * R * d;
  const TW* ue = wu + (size_t)we * d * F;
  const TW* ge = wg + (size_t)we * d * F;
  const TW* de = wd + (size_t)we * F * d;
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
// Adds one group's rows to a 64x64 tile of C held in acc; rows of A and B
// are contiguous along m and n.
template <typename TA, typename TB>
__device__ __forceinline__ void atb_acc(const TA* __restrict__ A,
                                        const TB* __restrict__ B, int R,
                                        int M, int N, int m0, int n0,
                                        float (*sA)[BN + 1],
                                        float (*sB)[BN + 1],
                                        float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
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
}

__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN],
                                           float* __restrict__ C, int M,
                                           int N, int m0, int n0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
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

// blockIdx.z = which * Ew + e, which 0: dWu = h^T DU, 1: dWg = h^T DG,
// 2: dWd = P^T dy, for weight group e: the sum over the row groups that
// read it (widx[g] == e, ascending g; null map: group e alone), all in one
// accumulator. blockIdx.x enumerates the 64x64 tiles of the output.
template <typename TH>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const TH* __restrict__ h, const TH* __restrict__ dy,
             const float* __restrict__ P, const float* __restrict__ DU,
             const float* __restrict__ DG, float* __restrict__ dwu,
             float* __restrict__ dwg, float* __restrict__ dwd,
             const int* __restrict__ widx, int G, int Ew, int R, int d,
             int F) {
  __shared__ float sA[BK][BN + 1];
  __shared__ float sB[BK][BN + 1];
  const int which = blockIdx.z / Ew;
  const int e = blockIdx.z % Ew;
  const size_t w = (size_t)e * d * F;
  const int M = which < 2 ? d : F;
  const int N = which < 2 ? F : d;
  const int nt = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / nt) * BN;
  const int n0 = (blockIdx.x % nt) * BN;
  if (m0 >= M) return;
  float acc[TM][TN] = {};
  for (int g = widx ? 0 : e; g < (widx ? G : e + 1); ++g) {
    if (widx && widx[g] != e) continue;   // uniform over the block
    const size_t rd = (size_t)g * R * d, rf = (size_t)g * R * F;
    if (which == 0)
      atb_acc(h + rd, DU + rf, R, M, N, m0, n0, sA, sB, acc);
    else if (which == 1)
      atb_acc(h + rd, DG + rf, R, M, N, m0, n0, sA, sB, acc);
    else
      atb_acc(P + rf, dy + rd, R, M, N, m0, n0, sA, sB, acc);
  }
  store_tile(acc, which == 0 ? dwu + w : which == 1 ? dwg + w : dwd + w, M,
             N, m0, n0);
}

// ---- 3. dh = DU @ Wu^T + DG @ Wg^T ----------------------------------------
template <typename TH, typename TW>
__global__ void __launch_bounds__(NT)
dh_kernel(const float* __restrict__ DU, const float* __restrict__ DG,
          const TW* __restrict__ wu, const TW* __restrict__ wg,
          TH* __restrict__ dh, const int* __restrict__ widx, int R, int d,
          int F) {
  __shared__ float sU[BK][BM + 1];
  __shared__ float sG[BK][BM + 1];
  __shared__ float sWu[BK][BN];
  __shared__ float sWg[BK][BN];
  const int e = blockIdx.z;
  const int we = widx ? widx[e] : e;
  if (we < 0) return;   // idle: zero_idle_groups writes its dh
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* ue = DU + (size_t)e * R * F;
  const float* ge = DG + (size_t)e * R * F;
  const TW* wue = wu + (size_t)we * d * F;
  const TW* wge = wg + (size_t)we * d * F;
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
            float* P, float* DU, float* DG, const int* widx, int E, int Ew,
            int R, int d, int F, int act, cudaStream_t s) {
  const TH* th = static_cast<const TH*>(h);
  const TH* tdy = static_cast<const TH*>(dy);
  const TW* tu = static_cast<const TW*>(wu);
  const TW* tg = static_cast<const TW*>(wg);
  const dim3 g1((F + BN - 1) / BN, (R + BM - 1) / BM, E);
  hidden_kernel<TH, TW><<<g1, NT, 0, s>>>(th, tdy, tu, tg,
                                          static_cast<const TW*>(wd), P, DU,
                                          DG, widx, R, d, F, act);
  const int tiles = ((d + BN - 1) / BN) * ((F + BN - 1) / BN);
  wgrad_kernel<TH><<<dim3(tiles, 1, 3 * Ew), NT, 0, s>>>(
      th, tdy, P, DU, DG, dwu, dwg, dwd, widx, E, Ew, R, d, F);
  const dim3 g3((d + BN - 1) / BN, (R + BM - 1) / BM, E);
  dh_kernel<TH, TW><<<g3, NT, 0, s>>>(DU, DG, tu, tg, static_cast<TH*>(dh),
                                      widx, R, d, F);
  if (widx) launch_zero_idle<TH>(widx, dh, E, (size_t)R * d, s);
}


// ---------------------------------------------------------------------------
// the tensor-core route (bf16 h and dy, d and F multiples of 64)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;      // output rows per tile: two warpgroups of 64
constexpr int BK = 64;       // depth of a stage: one 128-byte swizzle row
constexpr int NT = 384;      // 2 consumer warpgroups + 1 producer warpgroup
constexpr int CONSUMER_WARPS = 8;
// registers per thread after setmaxnreg: the consumers hold up to two
// 64-register accumulators through the epilogue; the producer warpgroup
// (one thread issues the copies) gives its share up. 2 x 128 x 232 +
// 128 x 40 = 64512 of the SM's 65536.
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int ROW_B = 128;   // bytes of one swizzled row
constexpr int BOX = 64 * 64 * 2;   // one [64 x 64] bf16 box, 8 KB

// Descriptors of the 16 K-columns kk of a tile at `t`: K-major, they sit
// 32 bytes into each 128-byte row; MN-major, they are 16 rows further on.
// An MN-major operand two atoms wide has them `lbo` bytes apart.
__device__ __forceinline__ uint64_t kmaj(uint32_t t, int kk) {
  return desc_sw128(t + kk * 32);
}
__device__ __forceinline__ uint64_t mnmaj(uint32_t t, int kk,
                                          uint32_t lbo = BOX) {
  return desc_sw128(t + kk * 16 * ROW_B, lbo);
}

struct Tile {
  int r0, n0, e;   // first output row, first output column, output group
  int we;          // the weights' group (Gated, Rows): widx[e], or e
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Output tiles, columns fastest, then rows, then the expert.
__host__ __device__ __forceinline__ Tile tile_at(int tile, int rows, int cols,
                                                 int bn) {
  const int n_nt = cdiv(cols, bn), n_rt = cdiv(rows, BM);
  const int e = tile / (n_nt * n_rt);
  return Tile{(tile / n_nt % n_rt) * BM, (tile % n_nt) * bn, e, e};
}

// tile_at over the live row groups of a map (common.cuh): the tile's
// third index counts live groups, and its weights are widx[e]. A null map
// is tile_at itself.
__device__ __forceinline__ Tile mapped_tile(const int* widx, int G, int tile,
                                            int rows, int cols, int bn) {
  Tile t = tile_at(tile, rows, cols, bn);
  if (widx) {
    t.e = map_nth_live(widx, G, t.e);
    t.we = widx[t.e];
  }
  return t;
}

__device__ __forceinline__ int live_groups(const int* widx, int G) {
  return widx ? map_live(widx, G) : G;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A lane holds two neighbouring columns (one 32-bit word of bf16) of its
// row in each 8-column group: w0 in group i, w1 in group i + 1. Paired
// with the next lane (the other half of the quad's 16 columns), it stores
// 8 bytes: even lanes four columns of group i, odd lanes of group i + 1,
// so each row's 32 bytes leave in one sector. `o` points at the lane's
// column in group i; all lanes call it (the shuffle), `live` ones store.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* o, uint32_t w0,
                                             uint32_t w1, bool odd,
                                             bool live) {
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 1);
  if (!live) return;
  if (odd)
    *reinterpret_cast<uint2*>(o + 6) = make_uint2(got, w1);
  else
    *reinterpret_cast<uint2*>(o) = make_uint2(w0, got);
}

// act(x) and act'(x) with one exp (silu) or one tanh (gelu), by the
// formulas of common.cuh
template <int ACT>
__device__ __forceinline__ void act_and_grad(float x, float& a, float& da) {
  if constexpr (ACT == 0) {
    const float s = 1.0f / (1.0f + expf(-x));
    a = x * s;
    da = s * (1.0f + x * (1.0f - s));
  } else {
    const float t = tanhf(GELU_K0 * (x + GELU_K1 * x * x * x));
    const float du = GELU_K0 * (1.0f + 3.0f * GELU_K1 * x * x);
    a = 0.5f * x * (1.0f + t);
    da = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
  }
}

// ---- 1. hidden, in two products. dhh [R, F] = dy W_down^T comes first
// (Rows<1, true, S>, below); then gt and up [R, F] from h, two accumulators
// of 128 columns, whose epilogue reads dhh and stores P, DU and DG, each as
// its hi and lo bf16 terms. Tiles of 128 x 128 over K = d. SPLIT: the
// weights come as hi and lo terms (f32 masters), else as bf16 alone; ACT
// 0 = silu, 1 = gelu.
struct GatedParams {
  CUtensorMap h, wg[2], wu[2];   // [hi, lo]
  const float* dhh;
  __nv_bfloat16* out;   // P hi, P lo, DU hi, DU lo, DG hi, DG lo
  const int* widx;      // group map, or null
  int E, R, d, F;       // E: row groups
};

template <bool SPLIT, int ACT>
struct Gated {
  using Params = GatedParams;
  static constexpr int BN = 128, STAGES = 2;
  // a stage: h [128 r x 64 k] K-major; w_gate hi, lo and w_up hi, lo, each
  // two [64 k x 64 n] boxes side by side (N contiguous: MN-major)
  static constexpr int H = 0, WG = 2 * BOX, WU = 6 * BOX, STAGE = 10 * BOX;
  static constexpr int TERMS = SPLIT ? 2 : 1;
  struct Acc {
    float gt[64], up[64];
  };

  static __host__ __device__ int tiles(const Params& p, int groups) {
    return cdiv(p.F, BN) * cdiv(p.R, BM) * groups;
  }
  static __device__ int groups(const Params& p) {
    return live_groups(p.widx, p.E);
  }
  static __device__ int depth(const Params& p, const Tile&) {
    return p.d / BK;
  }
  static __device__ Tile tile(const Params& p, int t) {
    return mapped_tile(p.widx, p.E, t, p.R, p.F, BN);
  }
  static __device__ int stage_bytes(const Params&) {
    return SPLIT ? STAGE : STAGE - 4 * BOX;
  }
  static __device__ void load(const Params& p, const Tile& t, int kt,
                              uint32_t st, uint32_t bar) {
    const int k0 = kt * BK;
    tma_load_3d(st + H, &p.h, bar, k0, t.r0, t.e);
#pragma unroll
    for (int j = 0; j < TERMS; ++j) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        tma_load_3d(st + WG + (2 * j + b) * BOX, &p.wg[j], bar,
                    t.n0 + 64 * b, k0, t.we);
        tma_load_3d(st + WU + (2 * j + b) * BOX, &p.wu[j], bar,
                    t.n0 + 64 * b, k0, t.we);
      }
    }
  }
  // acc_in = 0 on a tile's first stage: its first products overwrite
  static __device__ void mma(Acc& a, uint32_t st, int wg, int acc_in) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dh = kmaj(st + H + wg * 64 * ROW_B, kk);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) {
        const int in = acc_in | kk | j;
        wgmma_m64n128k16_ss<1>(a.gt, dh, mnmaj(st + WG + 2 * j * BOX, kk),
                               in);
        wgmma_m64n128k16_ss<1>(a.up, dh, mnmaj(st + WU + 2 * j * BOX, kk),
                               in);
      }
    }
  }
  static __device__ void fence(Acc& a) {
    fence_regs(a.gt);
    fence_regs(a.up);
  }
  static __device__ void store(const Params& p, const Tile& t, Acc& a,
                               int row0, int c8) {
    const size_t plane = (size_t)p.E * p.R * p.F;
    const bool odd = c8 & 2;
#pragma unroll
    for (int i = 0; i < BN / 8; i += 2) {
      // groups i and i + 1 (16 columns) lie inside F or past it together
      if (t.n0 + 8 * i >= p.F) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // registers 4i, 4i+1: row0; 4i+2, 4i+3: row0 + 8
        const int row = row0 + 8 * half;
        const bool live = row < p.R;
        const size_t o = ((size_t)t.e * p.R + (live ? row : 0)) * p.F +
                         t.n0 + 8 * i + c8;
        uint32_t w[6][2];   // P, DU, DG, each hi then lo; groups i, i + 1
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float2 dhh =
              *reinterpret_cast<const float2*>(p.dhh + o + 8 * g);
          float v[3][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = 4 * (i + g) + 2 * half + j;
            const float gt = a.gt[k], up = a.up[k];
            const float dy = j ? dhh.y : dhh.x;
            float av, dav;
            act_and_grad<ACT>(gt, av, dav);
            v[0][j] = av * up;
            v[1][j] = dy * av;
            v[2][j] = dy * up * dav;
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v[q][0], v[q][1]);
            const float2 hf = __bfloat1622float2(hi);
            w[2 * q][g] = *reinterpret_cast<const uint32_t*>(&hi);
            w[2 * q + 1][g] = bf16x2_bits(v[q][0] - hf.x, v[q][1] - hf.y);
          }
        }
#pragma unroll
        for (int q = 0; q < 6; ++q)
          store_bf16x4(p.out + q * plane + o, w[q][0], w[q][1], odd, live);
      }
    }
  }
};

// ---- 2. wgrad: C [M, N] = sum over r < R of A[r, M]^T B[r, N], f32; tiles
// of 128 x 128 over K = R (rows past R load as zeros). SPLIT_A: A = P (hi,
// lo), B = dy (dWd: M = F, N = d); else A = h, B = DU or DG (hi, lo) (dWu,
// dWg: M = d, N = F). Both operands MN-major.
struct WgradParams {
  CUtensorMap x[3];
  float* out;
  const int* widx;   // group map, or null
  int E, R, M, N;    // E: weight groups (the output's)
  int G;             // row groups of the operands
};

// The j-th row group that reads weight group e (ascending), G when there is
// none: past the operands' groups, so TMA brings zeros.
__device__ __forceinline__ int reader(const WgradParams& p, int e, int j) {
  if (!p.widx) return j == 0 ? e : p.G;
  for (int g = 0; g < p.G; ++g)
    if (p.widx[g] == e && j-- == 0) return g;
  return p.G;
}

__device__ __forceinline__ int readers(const WgradParams& p, int e) {
  if (!p.widx) return 1;
  int n = 0;
  for (int g = 0; g < p.G; ++g) n += p.widx[g] == e;
  return n;
}

template <bool SPLIT_A>
struct Wgrad {
  using Params = WgradParams;
  static constexpr int BN = 128, STAGES = 4;
  // a stage: x[0], x[1], x[2], each two [64 r x 64] boxes side by side
  // (one per 64 of M or N): A hi, A lo, B (SPLIT_A) or A, B hi, B lo
  static constexpr int STAGE = 6 * BOX;
  struct Acc {
    float c[64];
  };

  static __host__ __device__ int tiles(const Params& p, int groups) {
    return cdiv(p.N, BN) * cdiv(p.M, BM) * groups;
  }
  static __device__ int groups(const Params& p) { return p.E; }
  // K runs over the rows of every row group that reads the tile's weights,
  // one group after the other into one accumulator (at least one group's
  // depth, so a weight no group reads gets zeros)
  static __device__ int depth(const Params& p, const Tile& t) {
    const int n = readers(p, t.e);
    return (n > 0 ? n : 1) * cdiv(p.R, BK);
  }
  static __device__ Tile tile(const Params& p, int t) {
    return tile_at(t, p.M, p.N, BN);
  }
  static __device__ int stage_bytes(const Params&) { return STAGE; }
  static __device__ void load(const Params& p, const Tile& t, int kt,
                              uint32_t st, uint32_t bar) {
    const int nr = cdiv(p.R, BK);
    const int k0 = (kt % nr) * BK;
    const int g = reader(p, t.e, kt / nr);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const bool over_m = SPLIT_A ? x < 2 : x == 0;
      const int c0 = over_m ? t.r0 : t.n0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_3d(st + (2 * x + j) * BOX, &p.x[x], bar, c0 + 64 * j, k0,
                    g);
    }
  }
  static __device__ void mma(Acc& a, uint32_t st, int wg, int acc_in) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int in = acc_in | kk;
      if constexpr (SPLIT_A) {
        const uint64_t db = mnmaj(st + 4 * BOX, kk);
        wgmma_m64n128k16_ss<1, 1>(a.c, mnmaj(st + wg * BOX, kk), db, in);
        wgmma_m64n128k16_ss<1, 1>(a.c, mnmaj(st + (2 + wg) * BOX, kk), db,
                                  1);
      } else {
        const uint64_t da = mnmaj(st + wg * BOX, kk);
        wgmma_m64n128k16_ss<1, 1>(a.c, da, mnmaj(st + 2 * BOX, kk), in);
        wgmma_m64n128k16_ss<1, 1>(a.c, da, mnmaj(st + 4 * BOX, kk), 1);
      }
    }
  }
  static __device__ void fence(Acc& a) { fence_regs(a.c); }
  static __device__ void store(const Params& p, const Tile& t, Acc& a,
                               int row0, int c8) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = t.n0 + 8 * i + c8;
      if (col >= p.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= p.M) continue;
        *reinterpret_cast<float2*>(
            p.out + ((size_t)t.e * p.M + row) * p.N + col) =
            make_float2(a.c[4 * i + 2 * half], a.c[4 * i + 2 * half + 1]);
      }
    }
  }
};

// ---- 3. out [R, N] = sum over a < NA of A_a (B_a hi + lo)^T over K, both
// K-major (B_a is a weight's own [N, K] rows); tiles of 128 x 128. The
// ring's stages take the pairs in turn: stage kt holds A_a and B_a's hi
// and lo for a = kt % NA at K offset (kt / NA) * 64.
//   dh  = Rows<2, false, S>: A = DU hi, DG hi [R, F]; B = w_up, w_gate
//         [d, F]; bf16 out [R, d];
//   dhh = Rows<1, true, S>:  A = dy [R, d]; B = w_down [F, d]; f32 out
//         [R, F].
template <int NA>
struct RowsParams {
  CUtensorMap a[NA], b[NA][2];   // b: [hi, lo]
  void* out;
  const int* widx;   // group map, or null
  int E, R, N, K;    // E: row groups
};

template <int NA, bool OUT_F32, bool SPLIT>
struct Rows {
  using Params = RowsParams<NA>;
  static constexpr int BN = 128, STAGES = 4;
  static constexpr int TERMS = SPLIT ? 2 : 1;
  // a stage: A [128 r x 64 k], then B hi and lo [128 n x 64 k], 16 KB each
  static constexpr int B = 2 * BOX, STAGE = 6 * BOX;
  struct Acc {
    float c[64];
  };

  static __host__ __device__ int tiles(const Params& p, int groups) {
    return cdiv(p.N, BN) * cdiv(p.R, BM) * groups;
  }
  static __device__ int groups(const Params& p) {
    return live_groups(p.widx, p.E);
  }
  static __device__ int depth(const Params& p, const Tile&) {
    return NA * (p.K / BK);
  }
  static __device__ Tile tile(const Params& p, int t) {
    return mapped_tile(p.widx, p.E, t, p.R, p.N, BN);
  }
  static __device__ int stage_bytes(const Params&) {
    return SPLIT ? STAGE : STAGE - 2 * BOX;
  }
  static __device__ void load(const Params& p, const Tile& t, int kt,
                              uint32_t st, uint32_t bar) {
    const bool second = NA == 2 && (kt & 1);
    const int k0 = (kt / NA) * BK;
    tma_load_3d(st, second ? &p.a[NA - 1] : &p.a[0], bar, k0, t.r0, t.e);
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
      tma_load_3d(st + B + 2 * j * BOX,
                  second ? &p.b[NA - 1][j] : &p.b[0][j], bar, k0, t.n0, t.we);
  }
  static __device__ void mma(Acc& acc, uint32_t st, int wg, int acc_in) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = kmaj(st + wg * 64 * ROW_B, kk);
#pragma unroll
      for (int j = 0; j < TERMS; ++j)
        wgmma_m64n128k16_ss<0>(acc.c, da, kmaj(st + B + 2 * j * BOX, kk),
                               acc_in | kk | j);
    }
  }
  static __device__ void fence(Acc& a) { fence_regs(a.c); }
  static __device__ void store(const Params& p, const Tile& t, Acc& a,
                               int row0, int c8) {
    const bool odd = c8 & 2;
#pragma unroll
    for (int i = 0; i < BN / 8; i += 2) {
      if (t.n0 + 8 * i >= p.N) break;   // 16 columns in or out together
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        const bool live = row < p.R;
        const size_t o = ((size_t)t.e * p.R + (live ? row : 0)) * p.N +
                         t.n0 + 8 * i + c8;
        const int k0 = 4 * i + 2 * half, k1 = k0 + 4;   // groups i, i + 1
        if constexpr (OUT_F32) {
          if (!live) continue;
          float* out = static_cast<float*>(p.out) + o;
          *reinterpret_cast<float2*>(out) = make_float2(a.c[k0], a.c[k0 + 1]);
          *reinterpret_cast<float2*>(out + 8) =
              make_float2(a.c[k1], a.c[k1 + 1]);
        } else {
          store_bf16x4(static_cast<__nv_bfloat16*>(p.out) + o,
                       bf16x2_bits(a.c[k0], a.c[k0 + 1]),
                       bf16x2_bits(a.c[k1], a.c[k1 + 1]), odd, live);
        }
      }
    }
  }
};

template <class P>
constexpr int smem_bytes() {
  // the ring; full[STAGES], empty[STAGES]; 1024 bytes of slack to align
  return P::STAGES * P::STAGE + 16 * P::STAGES + 1024;
}

// One block per SM walks the policy's output tiles: one thread of the
// producer warpgroup fills the ring, the two consumer warpgroups run wgmma
// on it and store their 64 rows of each tile. Every warpgroup issues its
// products whether or not its rows lie past the output's (they load as
// zeros; the stores skip them): a wgmma under a branch is serialised.
template <class P>
__global__ void __launch_bounds__(NT, 1)
bwd_wgmma_kernel(const __grid_constant__ typename P::Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the base to them, so
  // the descriptors' base offset is 0
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + P::STAGES * P::STAGE;
  const uint32_t bar_empty = bar_full + 8 * P::STAGES;
  // a map leaves idle row groups out of the walk (zero_idle_groups writes
  // their outputs that are read)
  const int n_tiles = P::tiles(p, P::groups(p));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // producer warpgroup: one thread issues every copy of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      const int bytes = P::stage_bytes(p);
      int t = 0;   // stages filled so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile tl = P::tile(p, tile);
        const int nk = P::depth(p, tl);
        for (int kt = 0; kt < nk; ++kt, ++t) {
          const int s = t % P::STAGES;
          mbar_wait(bar_empty + 8 * s, ((t / P::STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, bytes);
          P::load(p, tl, kt, base + s * P::STAGE, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows r0 + 64 wg .. + 63 of a tile;
  // this thread rows row0 and row0 + 8, and in each 8-column group the
  // columns c8, c8 + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int c8 = 2 * (lane % 4);
  int t = 0;   // stages consumed so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile tl = P::tile(p, tile);
    const int nk = P::depth(p, tl);
    typename P::Acc acc;
    for (int kt = 0; kt < nk; ++kt, ++t) {
      const int s = t % P::STAGES;
      mbar_wait(bar_full + 8 * s, (t / P::STAGES) & 1);
      wgmma_fence();
      P::mma(acc, base + s * P::STAGE, wg, kt > 0);
      wgmma_commit();
      wgmma_wait1();   // the previous stage's products have landed
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % P::STAGES));
      }
    }
    wgmma_wait0();
    P::fence(acc);
    // the tile's last stage is free: the producer fills the next tile's
    // stages while this one's epilogue runs
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % P::STAGES));
    P::store(p, tl, acc, tl.r0 + wg * 64 + 16 * (warp % 4) + lane / 4, c8);
  }
}

template <class P>
cudaError_t launch_policy(const typename P::Params& p, int n_sm,
                          cudaStream_t stream) {
  constexpr int bytes = smem_bytes<P>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_wgmma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const int tiles = P::tiles(p, p.E);   // at most: every group live
  if (tiles == 0) return cudaSuccess;
  bwd_wgmma_kernel<P><<<tiles < n_sm ? tiles : n_sm, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The policy with the weights' lo terms (split = 1) or without.
template <template <bool> class P>
cudaError_t launch_split(const typename P<true>::Params& p, int split,
                         int n_sm, cudaStream_t stream) {
  return split ? launch_policy<P<true>>(p, n_sm, stream)
               : launch_policy<P<false>>(p, n_sm, stream);
}

template <bool S>
using GatedSilu = Gated<S, 0>;
template <bool S>
using GatedGelu = Gated<S, 1>;

template <bool S>
using Dhh = Rows<1, true, S>;
template <bool S>
using Dh = Rows<2, false, S>;

}  // namespace tc

}  // namespace

// Launches the three kernels on `stream`; returns cudaGetLastError()
// (0 = ok). h_bf16 / w_bf16 select bf16 (1) or f32 (0) storage of h and dy
// (and dh) / of the weights; act 0 = silu, 1 = gelu. h, dy, dh are [E, R, d]
// (E row groups); the weights and dwu, dwg, dwd (f32 outputs) are [Ew, ...].
// widx: null (the identity, Ew = E) or int32 [E] on the device, the weight
// group each row group reads, -1 idle (its dh is zero); a weight's gradient
// sums the row groups that read it. P, DU, DG are f32 scratch of E * R * F
// elements each. Nothing is allocated here.
extern "C" int expert_ffn_bwd_launch(const void* h, const void* dy,
                                     const void* wu, const void* wg,
                                     const void* wd, void* dh, void* dwu,
                                     void* dwg, void* dwd, void* P, void* DU,
                                     void* DG, const void* widx, int E, int Ew,
                                     int R, int d, int F, int h_bf16,
                                     int w_bf16, int act, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fu = static_cast<float*>(dwu);
  float* fg = static_cast<float*>(dwg);
  float* fd = static_cast<float*>(dwd);
  float* p = static_cast<float*>(P);
  float* du = static_cast<float*>(DU);
  float* dg = static_cast<float*>(DG);
  const int* wi = static_cast<const int*>(widx);
  if (h_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(h, dy, wu, wg, wd, dh, fu, fg, fd,
                                         p, du, dg, wi, E, Ew, R, d, F, act,
                                         s);
  else if (h_bf16)
    launch<__nv_bfloat16, float>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du,
                                 dg, wi, E, Ew, R, d, F, act, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du,
                                 dg, wi, E, Ew, R, d, F, act, s);
  else
    launch<float, float>(h, dy, wu, wg, wd, dh, fu, fg, fd, p, du, dg, wi, E,
                         Ew, R, d, F, act, s);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: launches its six kernels on `stream`; returns a
// cudaError_t (0 = ok). h, dy [E, R, d] and dh bf16; the weights' hi terms
// wu, wg [Ew, d, F], wd [Ew, F, d] bf16, and with split = 1 their lo terms
// wu_lo, wg_lo, wd_lo (unread with split = 0); dwu, dwg, dwd f32, shaped
// like the weights; `scratch` of 8 * E * R * F bf16 elements (P, DU, DG,
// each hi then lo, then dhh in f32); widx as expert_ffn_bwd_launch's (dhh,
// gt/up and dh read the weights, hi and lo, of widx[e] by the third TMA
// coordinate; a weight gradient runs over the rows of its readers in turn).
// All contiguous and 16-byte aligned (the wrapper sees to it); d and F
// multiples of 64; act 0 = silu, 1 = gelu. Nothing is allocated here. A
// tensor map that fails to encode returns cudaErrorInvalidValue;
// cudaErrorNotSupported when cuTensorMapEncodeTiled cannot be found.
extern "C" int expert_ffn_bwd_wgmma_launch(
    const void* h, const void* dy, const void* wu, const void* wg,
    const void* wd, const void* wu_lo, const void* wg_lo, const void* wd_lo,
    void* dh, void* dwu, void* dwg, void* dwd, void* scratch,
    const void* widx, int E, int Ew, int R, int d, int F, int split, int act,
    void* stream) {
  using tc::BK;
  using tc::BM;
  using hopper::EncodeTiled;
  using hopper::tma_map_bf16_3d;
  cudaGetLastError();  // start from a clean slate; report only our launches
  if (d % BK != 0 || F % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int* wi = static_cast<const int*>(widx);
  __nv_bfloat16* sc = static_cast<__nv_bfloat16*>(scratch);
  const size_t plane = (size_t)E * R * F;
  // scratch planes: 0 P hi, 1 P lo, 2 DU hi, 3 DU lo, 4 DG hi, 5 DG lo,
  // 6-7 dhh (f32)
  const void* w_up[2] = {wu, split ? wu_lo : wu};
  const void* w_gate[2] = {wg, split ? wg_lo : wg};
  const void* w_down[2] = {wd, split ? wd_lo : wd};
  bool ok = true;

  // dhh = dy W_down^T (f32, in scratch planes 6-7), then gt and up
  float* dhh = reinterpret_cast<float*>(sc + 6 * plane);
  tc::RowsParams<1> pdd{};
  ok &= tma_map_bf16_3d(fn, &pdd.a[0], dy, E, R, d, BM);
  for (int j = 0; j < 2; ++j)
    ok &= tma_map_bf16_3d(fn, &pdd.b[0][j], w_down[j], Ew, F, d, 128);
  pdd.out = dhh;
  pdd.widx = wi;
  pdd.E = E, pdd.R = R, pdd.N = F, pdd.K = d;
  tc::GatedParams pga{};
  ok &= tma_map_bf16_3d(fn, &pga.h, h, E, R, d, BM);
  for (int j = 0; j < 2; ++j) {
    ok &= tma_map_bf16_3d(fn, &pga.wg[j], w_gate[j], Ew, d, F, BK);
    ok &= tma_map_bf16_3d(fn, &pga.wu[j], w_up[j], Ew, d, F, BK);
  }
  pga.dhh = dhh;
  pga.out = sc;
  pga.widx = wi;
  pga.E = E, pga.R = R, pga.d = d, pga.F = F;

  // dWu, dWg: A = h, B = DU or DG (hi, lo); dWd: A = P (hi, lo), B = dy
  tc::WgradParams pu{}, pg{}, pd{};
  ok &= tma_map_bf16_3d(fn, &pu.x[0], h, E, R, d, BK);
  ok &= tma_map_bf16_3d(fn, &pu.x[1], sc + 2 * plane, E, R, F, BK);
  ok &= tma_map_bf16_3d(fn, &pu.x[2], sc + 3 * plane, E, R, F, BK);
  pg.x[0] = pu.x[0];
  ok &= tma_map_bf16_3d(fn, &pg.x[1], sc + 4 * plane, E, R, F, BK);
  ok &= tma_map_bf16_3d(fn, &pg.x[2], sc + 5 * plane, E, R, F, BK);
  ok &= tma_map_bf16_3d(fn, &pd.x[0], sc, E, R, F, BK);
  ok &= tma_map_bf16_3d(fn, &pd.x[1], sc + plane, E, R, F, BK);
  ok &= tma_map_bf16_3d(fn, &pd.x[2], dy, E, R, d, BK);
  pu.out = static_cast<float*>(dwu);
  pg.out = static_cast<float*>(dwg);
  pd.out = static_cast<float*>(dwd);
  pu.widx = pg.widx = pd.widx = wi;
  pu.E = pg.E = pd.E = Ew;
  pu.G = pg.G = pd.G = E;
  pu.R = pg.R = pd.R = R;
  pu.M = pg.M = d, pu.N = pg.N = F;
  pd.M = F, pd.N = d;

  // dh: A = DU hi, DG hi; B = the weights' own [d, F] rows, hi and lo
  tc::RowsParams<2> pdh{};
  ok &= tma_map_bf16_3d(fn, &pdh.a[0], sc + 2 * plane, E, R, F, BM);
  ok &= tma_map_bf16_3d(fn, &pdh.a[1], sc + 4 * plane, E, R, F, BM);
  for (int j = 0; j < 2; ++j) {
    ok &= tma_map_bf16_3d(fn, &pdh.b[0][j], w_up[j], Ew, d, F, 128);
    ok &= tma_map_bf16_3d(fn, &pdh.b[1][j], w_gate[j], Ew, d, F, 128);
  }
  pdh.out = dh;
  pdh.widx = wi;
  pdh.E = E, pdh.R = R, pdh.N = d, pdh.K = F;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = tc::launch_split<tc::Dhh>(pdd, split, n_sm, s);
  if (e == cudaSuccess)
    e = act ? tc::launch_split<tc::GatedGelu>(pga, split, n_sm, s)
            : tc::launch_split<tc::GatedSilu>(pga, split, n_sm, s);
  if (e == cudaSuccess) e = tc::launch_policy<tc::Wgrad<false>>(pu, n_sm, s);
  if (e == cudaSuccess) e = tc::launch_policy<tc::Wgrad<false>>(pg, n_sm, s);
  if (e == cudaSuccess) e = tc::launch_policy<tc::Wgrad<true>>(pd, n_sm, s);
  if (e == cudaSuccess) e = tc::launch_split<tc::Dh>(pdh, split, n_sm, s);
  if (e != cudaSuccess || wi == nullptr) return static_cast<int>(e);
  launch_zero_idle<__nv_bfloat16>(wi, dh, E, (size_t)R * d, s);
  return static_cast<int>(cudaGetLastError());
}
