// The backward of the WKV6 recurrence (K7, csrc/wkv6.cu) for Hopper
// (sm_90a), plain C interface. Per (batch, head), with the state laid out
// [k][v] (row i, column j), the forward over S steps from S_0 is
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} +
//   k_t v_t^T.
// Given dy_t and dS_S (the final state's cotangent, or zeros), with
// a_t = sum_i r_i u_i k_i and vdy_t = v_t . dy_t, it walks t = S .. 1:
//   dv_t[j] = sum_i dS_t[i,j] k_i + a_t dy_j
//   dk_t[i] = sum_j dS_t[i,j] v_j + r_i u_i vdy_t
//   dr_t[i] = sum_j S_{t-1}[i,j] dy_j + u_i k_i vdy_t
//   dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//   du[i]  += r_i k_i vdy_t                  (summed over b and t)
//   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
// and returns dS_0, the initial state's gradient. Plain version:
// kernels/ref.py::wkv6_scan_bwd_ref. r, k, v, w, dy are [B, S, H, 64] f32,
// u [H, 64], the states [B, H, 64, 64]. It replaces no Pallas kernel: the
// reference differentiates its lax.scan (repro/models/ssm.py::_rwkv6_core).
//
// The states cannot be run backwards (w = exp(-exp(.)) can be tiny), and a
// record of every step is B H S 16 KB (5.4 GB at B = 4, S = 2048, H = 40).
// So one call makes three launches:
//  1. ckpt_kernel, CK_G = 4 blocks a (batch, head), each 16 state columns
//     (the columns' recurrences are independent), 64 threads of 4 rows x 4
//     columns: the state every C steps (before each chunk of C steps), its
//     update rounded as K7 rounds it, S = fma(w, S, k v), so that each
//     checkpoint is K7's state after the same steps bit for bit, the
//     chunks' k, w and v staged by cp.async CK_RING - 1 chunks ahead; then
//     a_t, summed in f64 and rounded to f32 once (K7's terms), and vdy_t
//     the same way, each a sequential sum over i in one thread, from tiles
//     of 32 steps' rows copied whole into shared memory.
//  2. bwd_kernel, G = 4 blocks a (batch, head), launched as one thread-block
//     cluster, each taking RB = 16 state rows (all 64 columns): a thread two
//     neighbouring rows and eight columns, 64 threads. It walks the chunks
//     in reverse, each staged by cp.async while the one after it (in time)
//     runs. A chunk is NSUB sub-chunks of D steps, the last first: the
//     sub-chunk's D states are recomputed from the checkpoint into
//     registers (passing through the earlier sub-chunks' steps), then
//     walked backwards. Every state element's recurrence, forward and
//     backward, is independent; only the outputs couple them, and the step
//     loop writes its share of them to shared memory with no shuffle and no
//     branch: a lane's partial of dr, dk and dw over its eight columns (a
//     fused multiply-add chain over each four, columns in order, then their
//     sum) for each of its rows, and dv's sum over its two rows. Every DR
//     steps (a round) the block sums them in fixed trees:
//       dr, dk, dw: the row's lane partials pairwise (with the lane's own
//         first level, partners at column distance 4, 8, 16, then 32: the
//         tree a butterfly over sixteen four-column lanes forms), then
//         fma(u_i k_i, vdy_t, .) for dr and fma(r_i u_i, vdy_t, .) for dk,
//         stored as rows (the thread of a row pair two neighbouring floats);
//       du: fma(r_i k_i, vdy_t, du_i) in its row's thread, t descending;
//       dv: each 16-row group's eight pair sums in order, ((p0 + p1) + p2)
//         ... + p7, pushed into the shared memory of the cluster's block that
//         writes those columns (distributed shared memory); after the
//         cluster's barrier that block writes
//         dv = fma(a_t, dy, ((P0 + P1) + P2) + P3).
//     The cluster barrier is split: a block arrives after pushing a round's
//     partials and waits a round later, after it has pushed the next
//     round's, before it writes that round's dv, so the blocks seldom wait
//     for one another; the inboxes rotate over three buffers, so that a
//     push never lands in a buffer its block still reads. Partial rows go
//     through shared memory swizzled (a float4 slot XOR the row pair), v,
//     dy and dv's partials with a thread's two column groups eight slots
//     apart, so that neither the step loop's stores nor the round's loads
//     conflict.
//  3. du_kernel: du = the sum of du_part over b, in b's order.
// No atomics: every sum has a fixed order, so two calls give the same bits,
// and the orders are those of the first design (tools/k7_baseline_wkv6_bwd.cu:
// a butterfly for the row sums, a pair shuffle, warps in order and blocks in
// order for dv), so the gradients are its bits.
//
// What bounds it on an H100: at B = 4, S = 2048, H = 40 the function must
// read r, k, v, w, dy and write dr, dk, dv, dw (9 x 84 MB, 0.23 ms at 3.35
// TB/s) against 14 f32 operations a state element and step (three for the
// state, k v then w S + k v; three for its gradient; two a multiply-add for
// each of the four sums) and 15 a head element and step, 19.1 GFLOP: 0.29
// ms at 67 TFLOP/s (chip_smoke.py computes and reports the bound). In
// instructions the floor is 8 an element-step (2 for the state, 2 for dS,
// one multiply-add a sum): 1.342e9 element-steps x 8 at 132 SMs x 128 lanes
// x 1.98 GHz is 0.32 ms. The step loop issues those 8 (and 2 more for each
// step the recompute passes), a thread's shared loads of its rows' r, k, w
// and its columns' v, dy, and 5 shared stores for 16 element-steps; the
// rounds add about one instruction an element-step. The checkpoints (B H
// S / C x 16 KB, 447 MB at C = 12) are written once and read once. The
// registers hold D x 16 states a thread, so D and the threads set the
// occupancy: the register file is split over an SM's four schedulers, and
// 2-warp blocks at 6 an SM put 3 warps on one of them, 168 registers a
// thread (D = 6); the 640 blocks of the train shape run in one round of
// 792 slots (tools/k7_bwd_variants.py measures the choices).

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int HD = 64;             // head size: state rows and columns
constexpr int G = 4;               // row blocks a (batch, head): a cluster
constexpr int D = 6;               // steps a sub-chunk, states in registers
constexpr int NSUB = 2;            // sub-chunks between checkpoints
constexpr int DR = 3;              // steps a round of sums
constexpr int SM_THREADS = 384;    // threads an SM the registers allow

constexpr int C = NSUB * D;        // steps between checkpoints
constexpr int RB = HD / G;         // rows a block
constexpr int NP = RB / 2;         // row pairs a block: a thread's rows
constexpr int CPT = 8;             // columns a thread
constexpr int TPR = HD / CPT;      // threads a row pair
constexpr int NT = NP * TPR;       // threads a block
constexpr int NGR = RB / 16;       // dv's 16-row groups a block
constexpr int CO = HD / G;         // dv's columns a block writes
constexpr int MINB = SM_THREADS / NT > 0 ? SM_THREADS / NT : 1;
constexpr int CK_G = 4;            // column blocks of the checkpoint pass
constexpr int CK_RING = 2;         // its chunks staged, CK_RING - 1 ahead
constexpr int CK_CB = HD / CK_G;   // its columns a block
constexpr int CK_NT = HD * CK_CB / 16; // its threads: 4 rows, 4 columns
constexpr int DT = CK_NT / 2;      // steps a tile of its a_t, vdy_t phase
constexpr int DROW = HD + 4;       // that tile's row stride in floats
static_assert(G == 1 || G == 2 || G == 4, "16-row groups within a block");
static_assert(D % DR == 0 && TPR == 8 &&
                  NT % 32 == 0 && NT <= 1024 && CK_NT == HD && DT == 32 &&
                  CK_RING >= 2,
              "layout");

struct Args {
  const float* r;     // [B, S, H, HD]
  const float* k;
  const float* v;
  const float* w;
  const float* u;     // [H, HD]
  const float* s_in;  // [B, H, HD, HD], or null for zeros
  const float* dy;    // [B, S, H, HD]
  const float* ds_T;  // [B, H, HD, HD], or null for zeros
  float* ckpt;        // [B, H, nch, HD, HD]
  float* at;          // [B, S, H]
  float* vdy;         // [B, S, H]
  float* du_part;     // [B, H, HD]
  float* dr;          // [B, S, H, HD]
  float* dk;
  float* dv;
  float* dw;
  float* du;          // [H, HD]
  float* ds0;         // [B, H, HD, HD], or null
  int B, S, H;
};

__device__ __forceinline__ int chunks(int S) { return (S + C - 1) / C; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

// ---------------------------------------------------------------------------
// Launch 1: the checkpoints, a_t and vdy_t.

struct CkSmem {
  float4 k[CK_RING][C][HD / 4], w[CK_RING][C][HD / 4];  // all rows
  float4 v[CK_RING][C][CK_CB / 4];                      // the block's columns
};

// The a_t / vdy_t phase's tile (over the ring): DT steps of r, k, v, dy,
// rows padded to DROW floats so that a warp's 16-byte loads of 32 rows
// meet each bank four times, no more.
struct CkDots {
  float4 r[DT][DROW / 4], k[DT][DROW / 4], v[DT][DROW / 4], y[DT][DROW / 4];
  double u[HD];
};
constexpr size_t CK_SMEM =
    sizeof(CkSmem) > sizeof(CkDots) ? sizeof(CkSmem) : sizeof(CkDots);

// The copies of the C steps of chunk c into its ring slot, committed as one
// group (an empty one past the chunks the pass needs, so that every thread
// counts the same groups).
__device__ __forceinline__ void ck_stage(CkSmem& sm, const Args& a, int c,
                                         int nch, size_t base, size_t step,
                                         int col0) {
  if (c + 1 < nch) {
    const int slot = c % CK_RING;
    const size_t off = base + (size_t)c * C * step;
    for (int x = threadIdx.x; x < C * (HD / 4); x += CK_NT) {
      const int t = x / (HD / 4), c4 = x % (HD / 4);
      const size_t o = off + t * step + 4 * c4;
      cp16(&sm.k[slot][t][c4], a.k + o);
      cp16(&sm.w[slot][t][c4], a.w + o);
    }
    for (int x = threadIdx.x; x < C * (CK_CB / 4); x += CK_NT) {
      const int t = x / (CK_CB / 4), c4 = x % (CK_CB / 4);
      cp16(&sm.v[slot][t][c4], a.v + off + t * step + col0 + 4 * c4);
    }
  }
  cp_commit();
}

// Block (b, h, g) takes columns CK_CB g .. + CK_CB - 1; thread x holds rows
// 4 (x / 4) .. + 3 and four of the columns, 16 states. Writes the state
// before each chunk, the chunks copied CK_RING - 1 ahead; then a_t and
// vdy_t of every CK_G-th tile of DT steps.
__global__ void __launch_bounds__(CK_NT) ckpt_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CkSmem& sm = *reinterpret_cast<CkSmem*>(smem_raw);
  const int g = blockIdx.x % CK_G, bh = blockIdx.x / CK_G;
  const int h = bh % a.H, b = bh / a.H;
  const int rg = threadIdx.x / (CK_CB / 4), q = threadIdx.x % (CK_CB / 4);
  const int col0 = CK_CB * g, j0 = col0 + 4 * q;
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.S * a.H + h) * HD;  // (b, 0, h, 0)
  const int nch = chunks(a.S);
  const size_t s0 = (size_t)(4 * rg) * HD + j0;  // my rows' first state
  float st[4][4];  // rows 4 rg + m, columns j0 + e
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 x =
        a.s_in == nullptr
            ? make_float4(0.f, 0.f, 0.f, 0.f)
            : *reinterpret_cast<const float4*>(
                  a.s_in + (size_t)bh * HD * HD + s0 + m * HD);
    st[m][0] = x.x, st[m][1] = x.y, st[m][2] = x.z, st[m][3] = x.w;
  }
  float* ck = a.ckpt + (size_t)bh * nch * HD * HD + s0;
  for (int c = 0; c + 1 < CK_RING; ++c)
    ck_stage(sm, a, c, nch, base, step, col0);
  for (int c = 0;; ++c) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(ck + (size_t)c * HD * HD + m * HD) =
          make_float4(st[m][0], st[m][1], st[m][2], st[m][3]);
    if (c + 1 == nch) break;  // the last chunk's end state is not needed
    // chunk c is whole (c + 1 < nch)
    ck_stage(sm, a, c + CK_RING - 1, nch, base, step, col0);
    cp_wait<CK_RING - 1>();
    __syncthreads();
    const int slot = c % CK_RING;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float4 k4 = sm.k[slot][t][rg], w4 = sm.w[slot][t][rg];
      const float4 v4 = sm.v[slot][t][q];
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      // K7's rounding: kv = k v, then S = fma(w, S, kv)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[m][e] = __fmaf_rn(ww[m], st[m][e], __fmul_rn(kk[m], vv[e]));
    }
    __syncthreads();  // the slot is free for the chunk CK_RING on
  }
  // a_t = sum_i r_i (u_i k_i), each product and the sum in f64 (K7's
  // terms), and vdy_t = sum_j v_j (1 dy_j) the same way, i in order: a
  // step's two sums in two threads (warp 0 a_t, warp 1 vdy_t), the tile's
  // rows copied whole first
  cp_wait<0>();
  __syncthreads();  // the ring is free
  CkDots& dt = *reinterpret_cast<CkDots*>(smem_raw);
  if (threadIdx.x < HD) dt.u[threadIdx.x] = double(a.u[(size_t)h * HD +
                                                       threadIdx.x]);
  const int which = threadIdx.x / DT, ts = threadIdx.x % DT;
  for (int t0 = g * DT; t0 < a.S; t0 += CK_G * DT) {
    const int n = min(DT, a.S - t0);
    for (int x = threadIdx.x; x < n * (HD / 4); x += CK_NT) {
      const int t = x / (HD / 4), c4 = x % (HD / 4);
      const size_t o = base + (size_t)(t0 + t) * step + 4 * c4;
      cp16(&dt.r[t][c4], a.r + o);
      cp16(&dt.k[t][c4], a.k + o);
      cp16(&dt.v[t][c4], a.v + o);
      cp16(&dt.y[t][c4], a.dy + o);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (ts < n) {
      const float4* x4 = which ? dt.v[ts] : dt.r[ts];
      const float4* y4 = which ? dt.y[ts] : dt.k[ts];
      double acc = 0.0;
#pragma unroll 4
      for (int m = 0; m < HD / 4; ++m) {
        const float4 xx = x4[m], yy = y4[m];
        const float xs[4] = {xx.x, xx.y, xx.z, xx.w};
        const float ys[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc = __fma_rn(double(xs[e]),
                         __dmul_rn(which ? 1.0 : dt.u[4 * m + e],
                                   double(ys[e])),
                         acc);
      }
      (which ? a.vdy : a.at)[((size_t)b * a.S + t0 + ts) * a.H + h] =
          static_cast<float>(acc);
    }
    __syncthreads();  // the tile is free
  }
}

// ---------------------------------------------------------------------------
// Launch 2: the reverse walk.

// The float4 slot of columns 4 c4 .. 4 c4 + 3 in a row of v, dy or dv's
// partials in shared memory: a thread's eight columns 8 q .. 8 q + 7 lie in
// slots q and q + 8, so that the eight threads of a row pair read or write
// eight neighbouring slots at once.
__device__ __forceinline__ int slot_of(int c4) {
  return (c4 & 1) * (HD / 8) + (c4 >> 1);
}

struct Stage {                       // one chunk's operands
  float4 v[C][HD / 4], dy[C][HD / 4];  // columns in slot_of order
  float r[C][RB], k[C][RB], w[C][RB];  // the block's rows
  float at[C], vdy[C];
};

struct Smem {
  Stage sg[2];
  // a round's row partials (dr, dk, dw): row pair p, lane q's two floats
  // (its rows') in float4 slot (q / 2) ^ ((p / 2) % 4), half q % 2
  float4 prow[3][DR][NP][TPR / 2];
  float4 ppair[DR][NP][HD / 4];    // dv's sums over each row pair, slot_of
  // dv's 16-row group partials of the block's columns, pushed by the
  // cluster's blocks: [round % 3][slot][group][column float4]
  float4 inbox[3][DR][4][CO / 4];
  float u[RB];
};

// The copies of chunk c's n steps into `sg`, committed as one group.
__device__ __forceinline__ void stage(Stage& sg, const Args& a, int c, int n,
                                      size_t base, size_t step, int row0,
                                      int b, int h) {
  const size_t off = base + (size_t)c * C * step;
  for (int x = threadIdx.x; x < n * (RB / 4); x += NT) {
    const int t = x / (RB / 4), c4 = x % (RB / 4);
    const size_t o = off + t * step + row0 + 4 * c4;
    cp16(&sg.r[t][4 * c4], a.r + o);
    cp16(&sg.k[t][4 * c4], a.k + o);
    cp16(&sg.w[t][4 * c4], a.w + o);
  }
  for (int x = threadIdx.x; x < n * (HD / 4); x += NT) {
    const int t = x / (HD / 4), c4 = x % (HD / 4);
    const size_t o = off + t * step + 4 * c4;
    cp16(&sg.v[t][slot_of(c4)], a.v + o);
    cp16(&sg.dy[t][slot_of(c4)], a.dy + o);
  }
  for (int t = threadIdx.x; t < n; t += NT) {
    const size_t o = ((size_t)b * a.S + (size_t)c * C + t) * a.H + h;
    cp4(&sg.at[t], a.at + o);
    cp4(&sg.vdy[t], a.vdy + o);
  }
  cp_commit();
}

// The cluster barrier in two halves (with G = 1, none: the block's own
// barriers order its writes): arrive releases the thread's writes, shared
// memory of other blocks included; wait returns once every thread of the
// cluster has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (G > 1)
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  if constexpr (G > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Stores x at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ void st_cluster(float4* p, int rank, float4 x) {
  if constexpr (G > 1) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_u32(p)), "r"(rank));
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     remote),
                 "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
                 : "memory");
  } else {
    *p = x;
  }
}

// The thread's eight columns of a staged row (slots q and q + 8).
__device__ __forceinline__ void cols8(float (&out)[CPT], const float4* row,
                                      int q) {
  const float4 lo = row[q], hi = row[HD / 8 + q];
  out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
  out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
}

// One step of the recurrence on the thread's two rows: K7's rounding.
__device__ __forceinline__ void update(float (&s)[2][CPT], const Stage& sg,
                                       int t, int p, int q) {
  const float2 kk = *reinterpret_cast<const float2*>(&sg.k[t][2 * p]);
  const float2 ww = *reinterpret_cast<const float2*>(&sg.w[t][2 * p]);
  float vv[CPT];
  cols8(vv, sg.v[t], q);
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    s[0][e] = __fmaf_rn(ww.x, s[0][e], __fmul_rn(kk.x, vv[e]));
    s[1][e] = __fmaf_rn(ww.y, s[1][e], __fmul_rn(kk.y, vv[e]));
  }
}

// A row's partial over the thread's eight columns: the multiply-add chains
// over its two groups of four, columns in order, then their sum (the first
// level of the row's tree).
__device__ __forceinline__ float row8(const float (&x)[CPT],
                                      const float (&y)[CPT]) {
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo = __fmaf_rn(x[e], y[e], lo);
    hi = __fmaf_rn(x[4 + e], y[4 + e], hi);
  }
  return __fadd_rn(lo, hi);
}

// The backward step at chunk step t on the thread's two rows from
// st = S_{t-1}: writes its partials into round slot dd, updates dS.
__device__ __forceinline__ void back_step(Smem& sm, const Stage& sg,
                                          const float (&st)[2][CPT],
                                          float (&ds)[2][CPT], int t, int dd,
                                          int p, int q) {
  const float2 rr = *reinterpret_cast<const float2*>(&sg.r[t][2 * p]);
  const float2 kk = *reinterpret_cast<const float2*>(&sg.k[t][2 * p]);
  const float2 ww = *reinterpret_cast<const float2*>(&sg.w[t][2 * p]);
  float vv[CPT], yy[CPT];
  cols8(vv, sg.v[t], q);
  cols8(yy, sg.dy[t], q);
  const float rw[2] = {rr.x, rr.y}, kw[2] = {kk.x, kk.y}, wv[2] = {ww.x, ww.y};
  float pr[2], pk[2], pw[2], pv[CPT];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    pr[m] = row8(st[m], yy);
    pk[m] = row8(ds[m], vv);
    pw[m] = row8(ds[m], st[m]);
  }
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    pv[e] = __fadd_rn(__fmul_rn(ds[0][e], kw[0]), __fmul_rn(ds[1][e], kw[1]));
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ds[m][e] = __fmaf_rn(wv[m], ds[m][e], __fmul_rn(rw[m], yy[e]));
  }
  const int slot = ((q >> 1) ^ (p >> 1)) & 3;
  reinterpret_cast<float2*>(&sm.prow[0][dd][p][slot])[q & 1] =
      make_float2(pr[0], pr[1]);
  reinterpret_cast<float2*>(&sm.prow[1][dd][p][slot])[q & 1] =
      make_float2(pk[0], pk[1]);
  reinterpret_cast<float2*>(&sm.prow[2][dd][p][slot])[q & 1] =
      make_float2(pw[0], pw[1]);
  sm.ppair[dd][p][q] = make_float4(pv[0], pv[1], pv[2], pv[3]);
  sm.ppair[dd][p][HD / 8 + q] = make_float4(pv[4], pv[5], pv[6], pv[7]);
}

// A round's sums (see the header) of its nv steps from chunk step t0, slot
// dd holding step t0 + dd; c the chunk, ib the round's inbox buffer.
__device__ __forceinline__ void round_sums(Smem& sm, const Stage& sg,
                                           const Args& a, int c, int t0,
                                           int nv, int ib, float& du_acc,
                                           size_t base, size_t step, int g) {
  const int x = threadIdx.x, row0 = RB * g;
  // dr, dk, dw: a job a (quantity, slot, row pair), both rows' trees over
  // the pair's eight lanes (each lane's value the tree's first level)
  for (int j = x; j < 3 * DR * NP; j += NT) {
    const int qty = j / (DR * NP), dd = (j / NP) % DR, p = j % NP;
    if (dd >= nv) continue;
    const float4* src = sm.prow[qty][dd][p];
    float s0[4], s1[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 f = src[m ^ ((p >> 1) & 3)];  // lanes 2m, 2m + 1
      s0[m] = __fadd_rn(f.x, f.z);
      s1[m] = __fadd_rn(f.y, f.w);
    }
    s0[0] = __fadd_rn(__fadd_rn(s0[0], s0[1]), __fadd_rn(s0[2], s0[3]));
    s1[0] = __fadd_rn(__fadd_rn(s1[0], s1[1]), __fadd_rn(s1[2], s1[3]));
    const int t = t0 + dd, il = 2 * p;
    const float vd = sg.vdy[t];
    float o0 = s0[0], o1 = s1[0];
    float* out = a.dw;
    if (qty == 0) {
      o0 = __fmaf_rn(__fmul_rn(sm.u[il], sg.k[t][il]), vd, o0);
      o1 = __fmaf_rn(__fmul_rn(sm.u[il + 1], sg.k[t][il + 1]), vd, o1);
      out = a.dr;
    } else if (qty == 1) {
      o0 = __fmaf_rn(__fmul_rn(sg.r[t][il], sm.u[il]), vd, o0);
      o1 = __fmaf_rn(__fmul_rn(sg.r[t][il + 1], sm.u[il + 1]), vd, o1);
      out = a.dk;
    }
    *reinterpret_cast<float2*>(out + base + ((size_t)c * C + t) * step +
                               row0 + il) = make_float2(o0, o1);
  }
  // du: the row's thread, steps in descending order
  if (x < RB) {
#pragma unroll
    for (int dd = DR - 1; dd >= 0; --dd)
      if (dd < nv) {
        const int t = t0 + dd;
        du_acc = __fmaf_rn(__fmul_rn(sg.r[t][x], sg.k[t][x]), sg.vdy[t],
                           du_acc);
      }
  }
  // dv: each 16-row group's pair sums in order, pushed to the block that
  // writes the columns
  for (int j = NT - 1 - x; j < DR * NGR * (HD / 4); j += NT) {
    const int dd = j / (NGR * (HD / 4)), gr = (j / (HD / 4)) % NGR,
              sl = j % (HD / 4);
    if (dd >= nv) continue;
    float4 s = sm.ppair[dd][8 * gr][sl];
#pragma unroll
    for (int m = 1; m < 8; ++m) s = add4(s, sm.ppair[dd][8 * gr + m][sl]);
    const int c4 = 2 * (sl % (HD / 8)) + sl / (HD / 8);  // slot_of's inverse
    st_cluster(&sm.inbox[ib][dd][NGR * g + gr][c4 % (CO / 4)],
               c4 / (CO / 4), s);
  }
}

// A round, packed: its chunk, its first step in the chunk, its steps, its
// inbox buffer.
__device__ __forceinline__ int pack_round(int c, int t0, int nv, int ib) {
  return (c << 14) | (t0 << 8) | (nv << 2) | ib;
}

// dv of the packed round `pr` for the block's CO columns: the four groups'
// partials added in order.
__device__ __forceinline__ void round_dv(Smem& sm, const Args& a, int pr,
                                         size_t base, size_t step, int g) {
  const int c = pr >> 14, t0 = (pr >> 8) & 63, nv = (pr >> 2) & 63,
            ib = pr & 3;
  const Stage& sg = sm.sg[c & 1];
  for (int j = threadIdx.x; j < DR * (CO / 4); j += NT) {
    const int dd = j / (CO / 4), cl = j % (CO / 4);
    if (dd >= nv) continue;
    const float4* in = sm.inbox[ib][dd][0];
    const float4 s = add4(add4(add4(in[cl], in[CO / 4 + cl]),
                               in[2 * (CO / 4) + cl]),
                          in[3 * (CO / 4) + cl]);
    const int t = t0 + dd, c4 = g * (CO / 4) + cl;
    const float at = sg.at[t];
    const float4 y = sg.dy[t][slot_of(c4)];
    *reinterpret_cast<float4*>(a.dv + base + ((size_t)c * C + t) * step +
                               4 * c4) =
        make_float4(__fmaf_rn(at, y.x, s.x), __fmaf_rn(at, y.y, s.y),
                    __fmaf_rn(at, y.z, s.z), __fmaf_rn(at, y.w, s.w));
  }
}

// The thread's two rows (eight columns each) of chunk c's checkpoint.
__device__ __forceinline__ void load_ckpt(float (&ck)[2][CPT], const Args& a,
                                          int bh, int c, int nch, int i0,
                                          int q) {
  const float* src = a.ckpt + ((size_t)bh * nch + c) * HD * HD +
                     (size_t)i0 * HD + CPT * q;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h4 = 0; h4 < 2; ++h4) {
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(src + m * HD + 4 * h4));
      ck[m][4 * h4] = x.x, ck[m][4 * h4 + 1] = x.y;
      ck[m][4 * h4 + 2] = x.z, ck[m][4 * h4 + 3] = x.w;
    }
}

// What the walk carries from round to round.
struct Walk {
  float ds[2][CPT];  // dS_t of the thread's rows
  float du_acc;      // thread x < RB: row RB g + x's du
  int ib;            // the round's inbox buffer, the round's index % 3
  int pend;          // the last round, packed, whose dv is to write (or 0)
};

// Sub-chunk s (nd steps, nd = D where FULL) of chunk c: its states
// recomputed from the checkpoint, then walked backwards a round at a time.
// Each round: the back steps write their partials; a block barrier; the
// round's sums, dv's group partials pushed across the cluster into the
// inbox buffer of the round's index % 3; the last round's dv once the
// cluster has arrived after pushing its partials (the wait a round after
// the arrival and after this round's sums, so that it seldom waits; three
// inbox buffers, so that no push lands in a buffer a block still reads); a
// block barrier (the partials' slots are free); this round's arrival.
template <bool FULL>
__device__ __forceinline__ void sub_chunk(Smem& sm, const Stage& sg,
                                          const Args& a, Walk& w, int c,
                                          int s, int nd, int bh, int g,
                                          int p, int q, size_t base,
                                          size_t step) {
  const int nch = chunks(a.S), i0 = RB * g + 2 * p;
  float st[D][2][CPT];  // st[d]: the state before step s D + d
  load_ckpt(st[0], a, bh, c, nch, i0, q);
  for (int pass = 0; pass < s; ++pass)  // the earlier sub-chunks' steps
#pragma unroll
    for (int d = 0; d < D; ++d) update(st[0], sg, pass * D + d, p, q);
#pragma unroll
  for (int d = 1; d < D; ++d) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < CPT; ++e) st[d][m][e] = st[d - 1][m][e];
    if (FULL || d < nd) update(st[d], sg, s * D + d - 1, p, q);
  }
#pragma unroll
  for (int rr = D / DR - 1; rr >= 0; --rr) {
    if (!FULL && rr * DR >= nd) continue;
    const int nv = FULL ? DR : min(DR, nd - rr * DR), t0 = s * D + rr * DR;
#pragma unroll
    for (int dd = DR - 1; dd >= 0; --dd) {
      if (!FULL && dd >= nv) continue;
      back_step(sm, sg, st[rr * DR + dd], w.ds, t0 + dd, dd, p, q);
    }
    __syncthreads();  // the round's partials are written
    round_sums(sm, sg, a, c, t0, nv, w.ib, w.du_acc, base, step, g);
    if (w.pend != 0) {  // the cluster has pushed the last round's partials
      cluster_wait();
      round_dv(sm, a, w.pend, base, step, g);
    }
    __syncthreads();  // the partials' slots are free
    cluster_arrive();
    w.pend = pack_round(c, t0, nv, w.ib);
    w.ib = w.ib == 2 ? 0 : w.ib + 1;
    // after a whole chunk's first round the chunk before it is copied into
    // the buffer of the chunk after it, whose last dv is written by now
    if (c > 0 && c + 1 < nch && s == NSUB - 1 && rr == D / DR - 1)
      stage(sm.sg[(c - 1) & 1], a, c - 1, C, base, step, RB * g, bh / a.H,
            bh % a.H);
  }
}

// Block (b, h, g), rank g of its cluster, takes rows RB g .. RB g + RB - 1;
// thread x has rows RB g + 2 (x / 8) and the next, columns 8 (x % 8) .. + 7.
__global__ void __launch_bounds__(NT, MINB) bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int g = blockIdx.x % G, bh = blockIdx.x / G;
  const int h = bh % a.H, b = bh / a.H;
  const int p = threadIdx.x / TPR, q = threadIdx.x % TPR;
  const int row0 = RB * g, i0 = row0 + 2 * p;
  const size_t step = (size_t)a.H * HD;
  const size_t base = ((size_t)b * a.S * a.H + h) * HD;
  const int nch = chunks(a.S);
  const size_t se = (size_t)bh * HD * HD + (size_t)i0 * HD + CPT * q;

  if (threadIdx.x < RB) sm.u[threadIdx.x] = a.u[(size_t)h * HD + row0 +
                                                threadIdx.x];
  Walk w;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h4 = 0; h4 < 2; ++h4) {
      const float4 x = a.ds_T == nullptr
                           ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : *reinterpret_cast<const float4*>(
                                 a.ds_T + se + m * HD + 4 * h4);
      w.ds[m][4 * h4] = x.x, w.ds[m][4 * h4 + 1] = x.y;
      w.ds[m][4 * h4 + 2] = x.z, w.ds[m][4 * h4 + 3] = x.w;
    }
  w.du_acc = 0.0f;
  w.ib = 0;
  w.pend = 0;
  stage(sm.sg[(nch - 1) & 1], a, nch - 1, a.S - (nch - 1) * C, base, step,
        row0, b, h);
  cluster_arrive();  // every block of the cluster runs before any push
  cluster_wait();
  for (int c = nch - 1; c >= 0; --c) {
    cp_wait<0>();
    __syncthreads();  // chunk c has landed
    const Stage& sg = sm.sg[c & 1];
    const int n = min(C, a.S - c * C);
    if (c == nch - 1 && c > 0)  // the buffer of the chunk before was unused
      stage(sm.sg[(c - 1) & 1], a, c - 1, C, base, step, row0, b, h);
    for (int s = NSUB - 1; s >= 0; --s) {
      const int nd = min(D, n - s * D);
      if (nd == D)
        sub_chunk<true>(sm, sg, a, w, c, s, nd, bh, g, p, q, base, step);
      else if (nd > 0)
        sub_chunk<false>(sm, sg, a, w, c, s, nd, bh, g, p, q, base, step);
    }
  }
  cluster_wait();  // the last round's pushes have landed
  round_dv(sm, a, w.pend, base, step, g);
  if (a.ds0 != nullptr)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h4 = 0; h4 < 2; ++h4)
        *reinterpret_cast<float4*>(a.ds0 + se + m * HD + 4 * h4) =
            make_float4(w.ds[m][4 * h4], w.ds[m][4 * h4 + 1],
                        w.ds[m][4 * h4 + 2], w.ds[m][4 * h4 + 3]);
  if (threadIdx.x < RB)
    a.du_part[(size_t)bh * HD + row0 + threadIdx.x] = w.du_acc;
}

// Launch 3: du[h, i] = sum over b of du_part[b, h, i], in b's order.
__global__ void du_kernel(const Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.H * HD) return;
  float s = 0.0f;
  for (int b = 0; b < a.B; ++b)
    s = __fadd_rn(s, a.du_part[(size_t)b * a.H * HD + x]);
  a.du[x] = s;
}

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (e == cudaSuccess && CK_SMEM > 48 * 1024)
    e = cudaFuncSetAttribute(ckpt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CK_SMEM);
  return e;
}

// The reverse walk's launch: B H G blocks in clusters of G.
cudaLaunchConfig_t walk_config(int B, int H, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * H * G));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

// The gradients of the WKV6 recurrence (see above). r, k, v, w, dy, dr,
// dk, dv, dw [B, S, H, hd]; u, du [H, hd]; s_in, ds_T (null: zeros), ds0
// (null: not wanted) [B, H, hd, hd]; the workspaces ckpt [B, H, nch, hd,
// hd] with nch = ceil(S / C) (C = wkv6_bwd_design's out[8]; another nch
// is refused), at and vdy [B, S, H], du_part [B, H, hd]. All f32 and
// contiguous, all but u, at, vdy and du_part 16-byte aligned. Takes hd =
// 64 and S >= 1 only. Launches three kernels on `stream`; returns
// cudaGetLastError() after them (0 = ok).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* s_in, const void* dy,
                               const void* ds_T, void* ckpt, void* at,
                               void* vdy, void* du_part, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0, int B,
                               int S, int H, int hd, int nch, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launches
  if (hd != HD || S <= 0 || nch != (S + C - 1) / C)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {r, k, v, w, s_in, dy, ds_T,
                        static_cast<const void*>(ckpt),
                        static_cast<const void*>(dr),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv),
                        static_cast<const void*>(dw),
                        static_cast<const void*>(ds0)})
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B == 0 || H == 0) return 0;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(r),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(w),
               static_cast<const float*>(u),    static_cast<const float*>(s_in),
               static_cast<const float*>(dy),   static_cast<const float*>(ds_T),
               static_cast<float*>(ckpt),       static_cast<float*>(at),
               static_cast<float*>(vdy),        static_cast<float*>(du_part),
               static_cast<float*>(dr),         static_cast<float*>(dk),
               static_cast<float*>(dv),         static_cast<float*>(dw),
               static_cast<float*>(du),         static_cast<float*>(ds0),
               B,                               S,
               H};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ckpt_kernel<<<B * H * CK_G, CK_NT, CK_SMEM, st>>>(a);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = walk_config(B, H, st, attr);
  e = cudaLaunchKernelEx(&cfg, bwd_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  du_kernel<<<(H * HD + 255) / 256, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The design and what the card keeps resident of it, into out[12]: the
// reverse walk's threads a block, shared bytes a block, registers a
// thread, local (spill) bytes a thread, resident blocks an SM (the
// occupancy calculator), resident clusters on the card (at the train
// shape's grid; 0 where the calculator cannot say); G, D, C (steps between
// checkpoints), DR; the checkpoint pass's registers and local bytes a
// thread. Returns 0 or the CUDA error.
extern "C" int wkv6_bwd_design(int* out, void* /*stream*/) {
  cudaError_t e = set_smem();
  int blocks = 0, clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bwd_kernel, NT,
                                                      sizeof(Smem));
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = walk_config(4, 40, nullptr, attr);
    if (cudaOccupancyMaxActiveClusters(&clusters, bwd_kernel, &cfg) !=
        cudaSuccess) {
      clusters = 0;
      cudaGetLastError();
    }
  }
  cudaFuncAttributes fa{}, fc{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, bwd_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fc, ckpt_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[12] = {NT,
                        static_cast<int>(sizeof(Smem)),
                        fa.numRegs,
                        static_cast<int>(fa.localSizeBytes),
                        blocks,
                        clusters,
                        G,
                        D,
                        C,
                        DR,
                        fc.numRegs,
                        static_cast<int>(fc.localSizeBytes)};
  for (int x = 0; x < 12; ++x) out[x] = vals[x];
  return 0;
}
