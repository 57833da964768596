// Masked pairwise similarity for Hopper (sm_90a), plain C interface.
//
//   out[g, i, j] = mask[g, i, j] ? (x_i . x_j * rsqrt(|x_i|^2 |x_j|^2 + 1e-8)
//                                   + 1) / 2
//                                : 0
//
// Replaces the Pallas kernel repro/kernels/similarity.py::_sim_kernel (K2),
// which the reference vmaps over the condensation groups: here one launch
// covers every group. x is [NG, G, d] in f32 or bf16, out [NG, G, G] f32.
// The Gram sum and both square sums are f32 sums in a fixed order (no
// atomics, no split reduction, no TF32), so a run repeats bit for bit and a
// recompute under activation checkpointing takes the same decisions.
//
// Two entries. masked_similarity_launch takes the mask as bytes [NG, G, G]
// (torch.bool). masked_similarity_fused_launch takes §V-A's skip rules
// instead (repro/condense/backends.py::fast_similarity): from the primary
// expert ids [NG, G] (int32 or int64, any element stride) and the carried
// similarity s_prev [NG, G, G] f32 (or none) each pair is cross-expert
// (0), known high, s_prev > s1 (1), known low, s_prev < s2 (0), or
// measured; the mask is formed on chip and never written to device
// memory. With LSH bucket codes [NG, G] int32
// (condense/backends.py's lsh backend) a pair that would be measured is
// measured only where its row's and column's codes are equal, else 0;
// the early-out below sees the restricted codes. Those are instances of
// their own (CODES): without codes the kernels are the exact entry's.
// It also
// writes each group's measured fraction, count / G^2 (an f32 division,
// exact at G = 128): the blocks of a group form one thread-block cluster
// and its first block sums their counts from their shared memory, in rank
// order. A group must fit one portable cluster, 8 tiles: G <= 256 on the
// tensor cores, G <= 128 on the FMA kernel (the path's G is at most 128).
//
// Two kernels, chosen by the caller (kernels/similarity.py::route):
//   - sim_wgmma_kernel<BM, BN, RULES, CODES> (bf16 rows, d a multiple of 16):
//     one block per BM x BN output tile of a group (TC_BM x TC_BN = 64 x 128:
//     at G = 128 a group is two blocks, 128 on the card; 64 x 64 and 128 x 128
//     were slower, tools/k2_variants.py), one warpgroup per 64 x 64 of it;
//     bf16 wgmma (m64n64k16, both operands K-major in shared memory) with f32
//     accumulators, over 64-wide slabs along d, two slabs to a barrier. A
//     slab's 16-byte chunks are loaded into registers one pair ahead, summed
//     there into the square sums (f32 FMAs, one partial sum per row and
//     16-byte chunk position, k ascending in each, the 8 positions added in
//     order at the end) and stored to a 4-slot ring in the 128-byte swizzle,
//     so the sums read no shared memory: the wgmma operands are its largest
//     traffic.
//     Where the tile's rows are among its columns' rows (always at
//     G <= 128) only the column rows load. bf16 x bf16 products are exact
//     in f32, so only the order of the sum differs from the FMA kernel's.
//     The epilogue normalises with rsqrtf (two ulps) and takes no branch
//     on the code.
//   - sim_kernel<TX, RULES, CODES> (f32 rows, or other d): 64 x 64 tiles
//     of f32 FMAs, each thread a 4 x 4 micro-tile strided by 16 (the
//     kernel of the first port, its arithmetic unchanged: IEEE 1 / sqrtf).
// Both first form their tile's codes (mask or skip rules), read coalesced
// 4 entries a thread at a time into shared memory: a tile with nothing to
// measure writes its zeros and ones and returns before loading any row
// (the TPU kernel's tile-level early-out).
//
// What bounds it on an H100: at moe-gpt2's full width (64 groups of
// G = 128, d = 768) one launch reads the bf16 rows of each group with an
// entry to measure (12.6 MB when all 64 have one) and writes 4.2 MB of f32
// output (plus 1 MB of mask, or 4.2 MB of s_prev), 1.6 GFLOP on the tensor
// cores (~2 us at 989 TFLOP/s): bytes, ~5.3 us with every group live
// (fused ~6.2 us). Of the f32 FMA kernel, operations: ~24 us at 67
// TFLOP/s. The tensor-core
// kernel takes about twice its bound: a tile with every entry skipped
// already takes ~4 us (the launch, the code phase, the output), and the
// codes must be read before the first row may load.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 64;   // output tile edge of the FMA kernel
constexpr int BK = 16;   // its slab depth along d
constexpr int TM = 4;    // rows per thread, strided by 16
constexpr int NT = 256;  // threads per block: 16 x 16

constexpr int MAX_CLUSTER = 8;  // portable cluster size: tiles per group

// an entry's code: write 0, write 1, or measure
constexpr uint32_t ZERO = 0, ONE = 1, MEASURE = 2;

// What decides an entry: the mask bytes, or the skip rules and where the
// group counts go.
struct MaskArgs {
  const uint8_t* mask;   // [NG, G, G] (contract entry)
  const void* expert;    // [NG, G] ids at element stride es (fused entry)
  const float* s_prev;   // [NG, G, G] or null
  const int* code;       // [NG, G] LSH bucket codes (CODES instances)
  float* frac;           // [NG] measured fraction
  long long es;
  int e64;
  float s1, s2;
};

__device__ __forceinline__ long long load_id(const MaskArgs& a, size_t k) {
  return a.e64 ? static_cast<const long long*>(a.expert)[k * a.es]
               : static_cast<const int*>(a.expert)[k * a.es];
}

// Code of one entry from its mask byte or s_prev value (v), whether its
// row's and column's experts agree, and (CODES) whether their bucket
// codes do: an uncertain pair of two buckets is 0, not measured.
template <bool RULES, bool CODES>
__device__ __forceinline__ uint32_t entry_code(const MaskArgs& a, float v,
                                               bool same, bool bucket) {
  if constexpr (!RULES) {
    return v != 0.0f ? MEASURE : ZERO;
  } else {
    if (!same) return ZERO;
    const uint32_t m = (!CODES || bucket) ? MEASURE : ZERO;
    if (a.s_prev == nullptr) return m;
    return v > a.s1 ? ONE : (v < a.s2 ? ZERO : m);
  }
}

// The BM x BN tile's codes, one byte each, into s_code (row stride BN + 4),
// read coalesced four entries at a time (the mask as 4-byte words, s_prev
// as 16-byte ones). A thread's quads share their 4 columns, so it loads
// their 4 column ids and one row id a quad itself (the row id is one
// address for the warp); every load is issued before any code is formed,
// and no barrier comes between; with CODES their bucket codes the same
// way. A thread keeps its quads' codes in q_code (4 bytes each). Returns
// the number of measured entries it found.
template <bool RULES, bool CODES, int BM, int BN, int NTH>
__device__ __forceinline__ int tile_codes(
    const MaskArgs& a, size_t gG, int G, int i0, int j0, uint8_t* s_code,
    uint32_t (&q_code)[BM * BN / 4 / NTH]) {
  constexpr int PER = BM * BN / 4 / NTH;
  constexpr int QR = BN / 4;    // quads a row
  static_assert(NTH % QR == 0, "a thread's quads share their columns");
  const int tid = threadIdx.x;
  const int lj = (tid % QR) * 4;
  const bool vec = G % 4 == 0;
  const bool reads = !RULES || a.s_prev != nullptr;
  float4 v[PER];
  long long rid[PER], cid[4];
  int rcode[PER], ccode[4];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = i0 + (tid + u * NTH) / QR, j = j0 + lj;
    const size_t o = (gG + i) * G + j;
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    rid[u] = 0;
    rcode[u] = 0;
    if (i >= G) continue;
    if constexpr (RULES) rid[u] = load_id(a, gG + i);
    if constexpr (CODES) rcode[u] = a.code[gG + i];
    if (!reads) continue;
    if (vec && j + 3 < G) {
      if constexpr (RULES) {
        v[u] = *reinterpret_cast<const float4*>(a.s_prev + o);
      } else {
        const uint32_t m = *reinterpret_cast<const uint32_t*>(a.mask + o);
        v[u] = make_float4(m & 0xff, (m >> 8) & 0xff, (m >> 16) & 0xff,
                           m >> 24);
      }
    } else {
      float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j + k < G) {
          if constexpr (RULES) e[k] = a.s_prev[o + k];
          else e[k] = a.mask[o + k];
        }
      }
      v[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cid[k] = RULES && j0 + lj + k < G ? load_id(a, gG + j0 + lj + k) : 0;
    ccode[k] = CODES && j0 + lj + k < G ? a.code[gG + j0 + lj + k] : 0;
  }
  int cnt = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int li = (tid + u * NTH) / QR;
    const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + li < G && j0 + lj + k < G) {
        const bool same = !RULES || rid[u] == cid[k];
        const uint32_t c =
            entry_code<RULES, CODES>(a, e[k], same, rcode[u] == ccode[k]);
        cnt += c == MEASURE;
        packed |= c << (8 * k);
      }
    }
    q_code[u] = packed;
    *reinterpret_cast<uint32_t*>(s_code + li * (BN + 4) + lj) = packed;
  }
  return cnt;
}

// A tile with nothing to measure: its zeros and ones from q_code, coalesced.
template <int BM, int BN, int NTH>
__device__ __forceinline__ void write_codes(
    float* og, int G, int i0, int j0,
    const uint32_t (&q_code)[BM * BN / 4 / NTH]) {
  constexpr int PER = BM * BN / 4 / NTH;
  constexpr int QR = BN / 4;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = threadIdx.x + u * NTH;
    const int i = i0 + q / QR, j = j0 + (q % QR) * 4;
    if (i >= G) continue;
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[k] = ((q_code[u] >> (8 * k)) & 0xff) == ONE ? 1.0f : 0.0f;
    float* o = og + (size_t)i * G + j;
    if (G % 4 == 0 && j + 3 < G) {
      *reinterpret_cast<float4*>(o) = make_float4(e[0], e[1], e[2], e[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j + k < G) o[k] = e[k];
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's count of measured entries (cnt per thread) -> its group's
// measured fraction. Every block of the group's cluster publishes its
// count (phase 0 of the cluster barrier) and goes on; block 0 waits for
// phase 0, sums the counts from the blocks' shared memory in rank order
// and arrives at phase 1; group_done() keeps every block alive until
// then. Every thread of the block calls both.
template <int NTH>
__device__ __forceinline__ void group_count(const MaskArgs& a, int cnt, int g,
                                            int G, int* sred) {
  constexpr int NW = NTH / 32;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (threadIdx.x % 32 == 0) sred[threadIdx.x / 32] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += sred[w];
    sred[NW] = t;
  }
  cluster_arrive();
  cg::cluster_group cl = cg::this_cluster();
  if (cl.block_rank() == 0) {
    cluster_wait();
    if (threadIdx.x == 0) {
      int total = 0;
      for (unsigned r = 0; r < cl.num_blocks(); ++r)
        total += *cl.map_shared_rank(&sred[NW], r);
      a.frac[g] = __fdiv_rn(static_cast<float>(total),
                            static_cast<float>(G) * static_cast<float>(G));
    }
    cluster_arrive();
  }
}

// Before a block of a cluster exits: block 0 has read every count.
__device__ __forceinline__ void group_done() {
  if (cg::this_cluster().block_rank() != 0) {
    cluster_wait();
    cluster_arrive();
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// f32 FMA kernel (any d; f32 rows keep f32 math)
// ---------------------------------------------------------------------------

template <typename TX, bool RULES, bool CODES>
__global__ void __launch_bounds__(NT)
sim_kernel(const TX* __restrict__ x, const MaskArgs a, float* __restrict__ out,
           int G, int d) {
  constexpr int PER = BT * BT / 4 / NT;
  __shared__ float sA[BK][BT + 1];  // row slab, transposed
  __shared__ float sB[BK][BT + 1];  // column slab, transposed
  __shared__ float sxx[BT];
  __shared__ float syy[BT];
  __shared__ int sred[NT / 32 + 1];
  __shared__ __align__(16) uint8_t s_code[BT * (BT + 4)];
  const int g = blockIdx.z;
  const int i0 = blockIdx.y * BT;
  const int j0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t gG = (size_t)g * G;
  float* og = out + gG * G;

  // ---- the tile's codes; tile-level early-out: anything to measure?
  uint32_t q_code[PER];
  const int cnt = tile_codes<RULES, CODES, BT, BT, NT>(a, gG, G, i0, j0,
                                                       s_code, q_code);
  const int any = __syncthreads_or(cnt);
  if constexpr (RULES) group_count<NT>(a, cnt, g, G, sred);
  if (!any) {
    write_codes<BT, BT, NT>(og, G, i0, j0, q_code);
    if constexpr (RULES) group_done();
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
      float av[TM], bv[TM];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        av[t] = sA[k][ty + 16 * t];
        bv[t] = sB[k][tx + 16 * t];
      }
#pragma unroll
      for (int p = 0; p < TM; ++p) {
#pragma unroll
        for (int q = 0; q < TM; ++q)
          acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
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
      const uint32_t c = s_code[(ty + 16 * p) * (BT + 4) + tx + 16 * q];
      float s = c == ONE ? 1.0f : 0.0f;
      if (c == MEASURE) {
        const float v = sxx[ty + 16 * p] * syy[tx + 16 * q] + 1e-8f;
        s = (acc[p][q] * (1.0f / sqrtf(v)) + 1.0f) * 0.5f;
      }
      og[(size_t)i * G + j] = s;
    }
  }
  if constexpr (RULES) group_done();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (wgmma; d a multiple of 16)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64, TC_BN = 128;  // the tensor-core kernel's tile
constexpr int SLAB = 64;    // slab depth along d: 128-byte rows, 8 chunks
constexpr int STAGES = 4;  // shared-memory slots of the slab ring
constexpr int PAIR = 2;    // slabs stored between two barriers
// A pair's slabs are held in registers one pair ahead. The slots of pair
// p are stored before barrier p, once every warpgroup has passed barrier
// p - 1 and so waited for the products of pair p - 2 - IN_FLIGHT: they must
// cover pair p - STAGES / PAIR.
constexpr int IN_FLIGHT = STAGES / PAIR - 2;
static_assert(IN_FLIGHT >= 0, "a slot refilled before its products ran");

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// what the threads stored (the generic proxy) becomes visible to wgmma's
// operand reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of chunk c (8 bf16) of slab row r: the 128-byte swizzle,
// 16-byte chunks XOR-ed with the row's place in its 8-row atom
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// sq + the squares of one 16-byte chunk's 8 bf16 elements, in order
__device__ __forceinline__ void sq8(const uint4& w, float& sq) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float lo = __uint_as_float(u[h] << 16);
    const float hi = __uint_as_float(u[h] & 0xffff0000u);
    sq = fmaf(lo, lo, sq);
    sq = fmaf(hi, hi, sq);
  }
}

// A row's square sum from the partial sums of its 8 chunk positions,
// held by 8 consecutive lanes (position = lane % 8), added in position
// order; the position-0 lane gets it.
__device__ __forceinline__ float row_total8(float p) {
  float t = p;
#pragma unroll
  for (int k = 1; k < 8; ++k) t += __shfl_down_sync(0xffffffffu, p, k);
  return t;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// threads: one warpgroup per 64 x 64 block of the BM x BN tile
template <int BM, int BN>
__host__ __device__ constexpr int wg_threads() { return BM * BN / 32; }

template <int BM, int BN>
__host__ __device__ constexpr size_t wg_smem() {
  return 1024                              // slack to align the slabs
         + STAGES * (BM + BN) * SLAB * 2   // row and column slabs
         + (BM + BN) * sizeof(float)       // square sums
         + BM * (BN + 4)                   // codes
         + (wg_threads<BM, BN>() / 32 + 1) * sizeof(int);
}

template <int BM, int BN, bool RULES, bool CODES>
__global__ void __launch_bounds__(wg_threads<BM, BN>())
sim_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const MaskArgs a,
                 float* __restrict__ out, int G, int d) {
  constexpr int NTH = wg_threads<BM, BN>();
  constexpr int A_B = BM * SLAB * 2;       // bytes of one row slab
  constexpr int B_B = BN * SLAB * 2;       // ... and of one column slab
  constexpr int PER = BM * BN / 4 / NTH;
  constexpr int LB = BN * 8 / NTH;         // column-row chunks a thread
  constexpr int LA = BM * 8 / NTH;         // row-row chunks a thread
  constexpr int WGN = BN / 64;             // warpgroups along the columns
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: the slabs start on one
  const uint32_t pad = ((hopper::smem_u32(smem_raw) + 1023u) & ~1023u) -
                       hopper::smem_u32(smem_raw);
  uint8_t* sB = smem_raw + pad;             // STAGES column slabs
  uint8_t* sA = sB + STAGES * B_B;          // STAGES row slabs
  float* syy = reinterpret_cast<float*>(sA + STAGES * A_B);
  float* sxx = syy + BN;
  uint8_t* s_code = reinterpret_cast<uint8_t*>(sxx + BM);
  int* sred = reinterpret_cast<int*>(s_code + BM * (BN + 4));

  const int g = blockIdx.z;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t gG = (size_t)g * G;
  float* og = out + gG * G;

  // ---- the tile's codes; tile-level early-out: anything to measure?
  uint32_t q_code[PER];
  const int cnt = tile_codes<RULES, CODES, BM, BN, NTH>(a, gG, G, i0, j0,
                                                        s_code, q_code);
  const int any = __syncthreads_or(cnt);
  if constexpr (RULES) group_count<NTH>(a, cnt, g, G, sred);
  if (!any) {
    write_codes<BM, BN, NTH>(og, G, i0, j0, q_code);
    if constexpr (RULES) group_done();
    return;
  }

  // The tile's rows are among its columns' rows when [i0, i0 + BM) lies in
  // [j0, j0 + BN) (at G <= BN, always): then only the columns' rows load,
  // and the row operand and row sums are read from them at a_off.
  const bool sub = i0 >= j0 && i0 + BM <= j0 + BN;
  const int a_off = sub ? i0 - j0 : 0;
  const __nv_bfloat16* xg = x + gG * d;
  // this thread's 16-byte chunks of a slab: chunk position cc = tid % 8 of
  // rows tid / 8 + u NTH / 8
  const int cc = tid % 8;
  const uint32_t a0 = hopper::smem_u32(sA), b0 = hopper::smem_u32(sB);
  const __nv_bfloat16* srcB[LB];
  const __nv_bfloat16* srcA[LA];
  bool okB[LB], okA[LA];
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const int r = tid / 8 + u * (NTH / 8);
    okB[u] = j0 + r < G;
    srcB[u] = xg + (size_t)(okB[u] ? j0 + r : 0) * d + 8 * cc;
  }
#pragma unroll
  for (int u = 0; u < LA; ++u) {
    const int r = tid / 8 + u * (NTH / 8);
    okA[u] = i0 + r < G;
    srcA[u] = xg + (size_t)(okA[u] ? i0 + r : 0) * d + 8 * cc;
  }
  const int n_slabs = (d + SLAB - 1) / SLAB;
  // slab s's chunks into registers (zeros past G rows or d columns)
  auto fetch = [&](int s, uint4 (&rb)[LB], uint4 (&ra)[LA]) {
    const int k0 = s * SLAB;
    const bool in_k = s < n_slabs && k0 + 8 * cc < d;
#pragma unroll
    for (int u = 0; u < LB; ++u)
      rb[u] = in_k && okB[u] ? *reinterpret_cast<const uint4*>(srcB[u] + k0)
                             : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < LA; ++u)
      ra[u] = in_k && okA[u] && !sub
                  ? *reinterpret_cast<const uint4*>(srcA[u] + k0)
                  : make_uint4(0, 0, 0, 0);
  };

  // warpgroup w: rows 64 (w / WGN) .., columns 64 (w % WGN) .. of the tile
  const int wg = warp / 4, wr = wg / WGN, wc = wg % WGN;
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
  // the square sums, from the registers each chunk passes through: one
  // partial sum per row this thread loads (its chunk position cc)
  float sqb[LB], sqa[LA];
#pragma unroll
  for (int u = 0; u < LB; ++u) sqb[u] = 0.0f;
#pragma unroll
  for (int u = 0; u < LA; ++u) sqa[u] = 0.0f;

  // slabs s, s + 1: their chunks (loaded one pair before) are summed and
  // stored to slots s % STAGES, (s + 1) % STAGES; the next pair's chunks
  // load into the same registers; one barrier; then the products of both
  uint4 rb[PAIR][LB], ra[PAIR][LA];
#pragma unroll
  for (int h = 0; h < PAIR; ++h) fetch(h, rb[h], ra[h]);
  auto store = [&](int s, uint4 (&cb)[LB], uint4 (&ca)[LA]) {
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      sq8(cb[u], sqb[u]);
      st_shared16(b0 + (s % STAGES) * B_B + swz(tid / 8 + u * (NTH / 8), cc),
                  cb[u]);
    }
    if (!sub) {
#pragma unroll
      for (int u = 0; u < LA; ++u) {
        sq8(ca[u], sqa[u]);
        st_shared16(a0 + (s % STAGES) * A_B + swz(tid / 8 + u * (NTH / 8), cc),
                    ca[u]);
      }
    }
  };
  // past the last slab a pair multiplies and sums zeros (and takes no
  // branch: a wgmma under one is serialised)
  for (int s = 0; s < n_slabs; s += PAIR) {
#pragma unroll
    for (int h = 0; h < PAIR; ++h) {
      store(s + h, rb[h], ra[h]);
      fetch(s + h + PAIR, rb[h], ra[h]);
    }
    fence_proxy_async();
    __syncthreads();   // the pair is in its slots for every warpgroup
    hopper::wgmma_fence();
#pragma unroll
    for (int h = 0; h < PAIR; ++h) {
      const uint32_t tb = b0 + ((s + h) % STAGES) * B_B;
      const uint32_t ta =
          sub ? tb + a_off * 128 : a0 + ((s + h) % STAGES) * A_B;
#pragma unroll
      for (int ks = 0; ks < SLAB / 16; ++ks)
        hopper::wgmma_m64n64k16_ss<0>(
            acc, hopper::desc_sw128(ta + wr * 64 * 128 + ks * 32),
            hopper::desc_sw128(tb + wc * 64 * 128 + ks * 32), 1);
    }
    hopper::wgmma_commit();
    wgmma_wait<IN_FLIGHT>();
  }
  hopper::wgmma_wait0();
  hopper::fence_regs(acc);
  // a row's square sum: its 8 chunk positions' partial sums (lanes
  // 8 (tid / 8) .. + 7), added in position order
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const float t = row_total8(sqb[u]);
    if (cc == 0) syy[tid / 8 + u * (NTH / 8)] = t;
  }
  if (!sub) {
#pragma unroll
    for (int u = 0; u < LA; ++u) {
      const float t = row_total8(sqa[u]);
      if (cc == 0) sxx[tid / 8 + u * (NTH / 8)] = t;
    }
  }
  __syncthreads();
  const float* rx = sub ? syy + a_off : sxx;   // the row rows' sums

  // ---- epilogue: acc[4 nt + 2 h + c] is the entry at row
  // 64 wr + 16 (warp % 4) + lane / 4 + 8 h, column 64 wc + 8 nt +
  // 2 (lane % 4) + c; no branch on the code
  const bool pairs = (G % 2) == 0;   // (j, j + 1) both in range, 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int li = 64 * wr + 16 * (warp % 4) + lane / 4 + 8 * h;
    const int i = i0 + li;
    const float xi = rx[li];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int lj = 64 * wc + 8 * nt + 2 * (lane % 4);
      const int j = j0 + lj;
      const uint32_t codes = *reinterpret_cast<const uint16_t*>(
          s_code + li * (BN + 4) + lj);
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t code = (codes >> (8 * c)) & 0xff;
        const float w = xi * syy[lj + c] + 1e-8f;
        const float m = (acc[4 * nt + 2 * h + c] * rsqrtf(w) + 1.0f) * 0.5f;
        v[c] = code == MEASURE ? m : (code == ONE ? 1.0f : 0.0f);
      }
      if (i >= G || j >= G) continue;
      float* o = og + (size_t)i * G + j;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      } else {
        o[0] = v[0];
        if (j + 1 < G) o[1] = v[1];
      }
    }
  }
  if constexpr (RULES) group_done();
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   bool cluster, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool RULES, bool CODES>
cudaError_t launch_wgmma(const void* x, const MaskArgs& a, float* out, int NG,
                         int G, int d, cudaStream_t s) {
  constexpr size_t smem = wg_smem<TC_BM, TC_BN>();
  static bool attr_set = false;   // per instantiation, once per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_wgmma_kernel<TC_BM, TC_BN, RULES, CODES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((G + TC_BN - 1) / TC_BN, (G + TC_BM - 1) / TC_BM, NG);
  return launch(sim_wgmma_kernel<TC_BM, TC_BN, RULES, CODES>, grid,
                wg_threads<TC_BM, TC_BN>(), smem, RULES, s,
                static_cast<const __nv_bfloat16*>(x), a, out, G, d);
}

// tc: the tensor-core kernel (bf16 rows, d % 16 == 0), else the FMA one.
// The fused entry's blocks of a group form a cluster.
template <bool RULES, bool CODES>
cudaError_t launch_any(const void* x, const MaskArgs& a, float* out, int NG,
                       int G, int d, int x_bf16, int tc, cudaStream_t s) {
  if (tc) return launch_wgmma<RULES, CODES>(x, a, out, NG, G, d, s);
  const dim3 grid((G + BT - 1) / BT, (G + BT - 1) / BT, NG);
  if (x_bf16)
    return launch(sim_kernel<__nv_bfloat16, RULES, CODES>, grid, NT, 0,
                  RULES, s, static_cast<const __nv_bfloat16*>(x), a, out, G,
                  d);
  return launch(sim_kernel<float, RULES, CODES>, grid, NT, 0, RULES, s,
                static_cast<const float*>(x), a, out, G, d);
}

bool bad_route(int x_bf16, int d, int tc) {
  return tc && (!x_bf16 || d % 16 != 0);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = ok). x_bf16
// selects bf16 (1) or f32 (0) rows; tc the tensor-core kernel (1) or the
// FMA one (0). Nothing is allocated here.
extern "C" int masked_similarity_launch(const void* x, const void* mask,
                                        void* out, int NG, int G, int d,
                                        int x_bf16, int tc, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  if (bad_route(x_bf16, d, tc)) return (int)cudaErrorInvalidValue;
  MaskArgs a = {};
  a.mask = static_cast<const uint8_t*>(mask);
  const cudaError_t e = launch_any<false, false>(
      x, a, static_cast<float*>(out), NG, G, d, x_bf16, tc,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return static_cast<int>(cudaGetLastError());
}

// The fused entry: expert ids [NG, G] (int64 if e64, else int32) at
// element stride es; s_prev [NG, G, G] f32 or null; code [NG, G] int32
// LSH bucket codes, contiguous, or null (the exact backend); out
// [NG, G, G] f32; frac [NG] f32. A group's tiles (TC_BM x TC_BN, or
// 64 x 64 on the FMA kernel) must fit one cluster.
extern "C" int masked_similarity_fused_launch(
    const void* x, const void* expert, const void* s_prev, const void* code,
    void* out, void* frac, int NG, int G, int d, int x_bf16, int tc, int e64,
    int es, float s1, float s2, void* stream) {
  cudaGetLastError();
  if (bad_route(x_bf16, d, tc)) return (int)cudaErrorInvalidValue;
  const int em = tc ? TC_BM : BT, en = tc ? TC_BN : BT;
  if (((G + em - 1) / em) * ((G + en - 1) / en) > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  MaskArgs a = {};
  a.expert = expert;
  a.s_prev = static_cast<const float*>(s_prev);
  a.code = static_cast<const int*>(code);
  a.frac = static_cast<float*>(frac);
  a.es = es;
  a.e64 = e64;
  a.s1 = s1;
  a.s2 = s2;
  const cudaError_t e =
      code ? launch_any<true, true>(x, a, static_cast<float*>(out), NG, G, d,
                                    x_bf16, tc,
                                    static_cast<cudaStream_t>(stream))
           : launch_any<true, false>(x, a, static_cast<float*>(out), NG, G,
                                     d, x_bf16, tc,
                                     static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return static_cast<int>(cudaGetLastError());
}
