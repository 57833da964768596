// WKV6 recurrence (RWKV-6 "Finch" time-mix core) for Hopper (sm_90a),
// plain C interface. Per (batch, head), over S steps from the state S_0 (or
// zeros), with the state laid out [k][v] (row i, column j):
//   y_t = r_t^T (S + diag(u) k_t v_t^T)
//   S   = diag(w_t) S + k_t v_t^T
// and the final state. r, k, v, w are [B, S, H, 64] f32 (w the decay in
// (0, 1)), u [H, 64] f32, the states [B, H, 64, 64] f32.
//
// Replaces no Pallas kernel: the reference computes this recurrence as a
// lax.scan (repro/models/ssm.py::_rwkv6_core), one step a loop iteration,
// and leaves a faster formulation to the kernel layer. On the card that
// scan in plain PyTorch costs six launches a token a layer; this kernel
// (K7) runs the whole sequence in one launch.
//
// The rank-one bonus leaves the state loop: r^T diag(u) k v^T is v_j a_t
// with a_t = sum_i r_i u_i k_i, one number a (batch, head, step). So per
// state element and step three f32 instructions remain, each rounded
// (explicit intrinsics: the compiler contracts nothing, and a step computes
// the same bits whether it is one launch's first or a longer launch's t-th,
// so S launches at S = 1, chained through the state, equal one launch over
// S bit for bit):
//   kv = k_i v_j;  acc = fma(r_i, S_ij, acc);  S_ij = fma(w_i, S_ij, kv)
// The state update is the recurrence's own order, one rounding for k v and
// one for the fused w S + kv, as the one-thread-a-column kernel this one
// replaced computed it: the final states agree bit for bit. y_j =
// fma(v_j, a_t, the lanes' partial sums added in a fixed tree). a_t sums
// its 64 products r_i (u_i k_i) in f64 over eight lanes of eight rows
// each, added by a butterfly, and is rounded to f32 once: at a first step
// from the zero state y is the bonus alone, and where its products cancel
// an f32 sum (or the plain version's per-element rounding) is off by up
// to 1e-4 of the row's norm; the f64 sum keeps y within about 2e-6 of an
// f64 recurrence (tools/k7_variants.py measures both).
//
// Layout: G = 4 blocks a (batch, head), neighbouring blockIdx, each taking
// CB = 16 state columns, with two compute warps and a producer warp. A
// column group of LPC = 16 neighbouring lanes holds CPL = 4 columns: lane
// q the rows 4 q .. 4 q + 3 of each, in registers for the whole sequence.
// Per step a lane reads its rows of r, k and w as one float4 each (the 16
// lanes of a group take 256 contiguous bytes: no bank conflict) and its
// four columns of v, so a lane's shared loads serve four columns at once;
// the group's partial sums of y meet by a reduce-scatter (each shuffle
// stage halves the columns a lane holds, with no select: register cc holds
// column cc ^ mine), and lane q < 4 stores one column's y_t straight to
// device memory, a warp's eight columns one 32-byte sector. U = 8 steps
// run as one group, their reductions interleaved. The producer warp stages
// chunks of T = 16 steps (r, k, w: all 64 rows; v: the block's columns)
// in shared memory by cp.async (16-byte copies) through a ring of three
// slots and sums a_t of each landed chunk; per slot, mbarriers count its
// copies landed, its a_t summed and the compute warps done with it, so no
// block-wide barrier runs a chunk and the producer works a chunk ahead.
// The state passes through shared memory as 16-byte rows at the start and
// the end. The decode step (S = 1) is one partial chunk. A phase that never
// completes traps after about two seconds instead of hanging the card.
//
// What bounds it on an H100: at a full-width prefill (B=4, S=2048, H=40,
// zero state) 420 MB of r, k, v, w, y and the state (0.126 ms at 3.35 TB/s)
// against 5 f32 operations a state element and step and 5 a head element
// and step for the bonus (6.7 GFLOP, 0.100 ms at 67 TFLOP/s);
// chip_smoke.py computes and reports the bound. The three instructions a
// state element and step give an issue floor of 1.34e9 x 3 lane
// instructions at 132 SMs x 128 lanes x 1.98 GHz, 0.12 ms. The kernel
// issues about five instructions an element (the loads, shuffles and
// stores beside the three), its 1280 compute warps leave two or three on
// each of the 528 schedulers, and so it runs at about a third of the
// byte bound. G > 1 reads r, k and w G times, from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int HD = 64;   // head size: state rows (k) and columns (v)
constexpr int G = 4;     // blocks a (batch, head)
constexpr int T = 16;    // steps a staged chunk
constexpr int RING = 3;  // staged chunks; RING - 2 copied ahead
constexpr int CPL = 4;   // state columns a lane
constexpr int LPC = 16;  // lanes a column group
constexpr int U = 8;     // steps a group, their reductions interleaved
using BonusT = double;   // the type a_t is summed in

constexpr int CB = HD / G;          // state columns a block
constexpr int NT = CB / CPL * LPC;  // compute threads a block
constexpr int NG4 = HD / 4 / LPC;   // float4 row groups a lane
constexpr int AL = 8;               // lanes that sum one step's a_t
constexpr int AHEAD = RING - 2;     // chunks copied ahead of the bonus
static_assert(HD == 64 && NT % 32 == 0 && NT + 32 <= 1024, "whole warps");
static_assert(CB % CPL == 0 && CPL <= LPC && (CPL & (CPL - 1)) == 0 &&
                  HD % (4 * LPC) == 0 && (LPC & (LPC - 1)) == 0 &&
                  CB % 4 == 0 && AHEAD >= 1,
              "layout");

struct Args {
  const float* r;     // [B, S, H, HD]
  const float* k;
  const float* v;
  const float* w;
  const float* u;     // [H, HD]
  const float* s_in;  // [B, H, HD, HD], or null for zeros
  float* y;           // [B, S, H, HD]
  float* s_out;       // [B, H, HD, HD]
  int S, H;
};

struct Smem {
  float4 r[RING][T][HD / 4], k[RING][T][HD / 4], w[RING][T][HD / 4];
  float v[RING][T][CB];
  float a[RING][T];  // a_t of each staged chunk
  BonusT u[HD];
  float s[HD][CB];   // the block's state columns at the start and the end
  // per slot: the producer's 32 lanes' copies have landed; its a_t is
  // summed (32 lanes); the compute warps are done with it (NT threads)
  uint64_t landed[RING], summed[RING], freed[RING];
};

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float fma_rn(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_rn(double x, double y, double z) {
  return __fma_rn(x, y, z);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed. A phase
// that has not completed after some 2^32 clocks (about two seconds) traps,
// so that a wrong phase fails the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

// The producer warp's copies of the n steps of chunk `c` into its slot, 16
// bytes a lane at a time: per step the 64 rows of r, k and w and the
// block's CB columns of v.
__device__ __forceinline__ void copy_chunk(Smem& sm, const Args& a, int lane,
                                           int c, int n, size_t row0,
                                           size_t step, int col0) {
  const int slot = c % RING;
  {
    constexpr int LS = 32 / (HD / 4);  // steps a pass
    const int t0 = lane / (HD / 4), c4 = lane % (HD / 4);
    const size_t off = row0 + t0 * step + 4 * c4;
    const float *r = a.r + off, *k = a.k + off, *w = a.w + off;
    for (int t = t0; t < n; t += LS, r += LS * step, k += LS * step,
             w += LS * step) {
      cp16(&sm.r[slot][t][c4], r);
      cp16(&sm.k[slot][t][c4], k);
      cp16(&sm.w[slot][t][c4], w);
    }
  }
  {
    constexpr int LS = 32 / (CB / 4);
    const int t0 = lane / (CB / 4), c4 = lane % (CB / 4);
    const float* v = a.v + row0 + t0 * step + col0 + 4 * c4;
    for (int t = t0; t < n; t += LS, v += LS * step)
      cp16(&sm.v[slot][t][4 * c4], v);
  }
}

// Arrives on `bar` once the lane's copies so far have completed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// copy_chunk, its completion counted on the slot's `landed`
__device__ __forceinline__ void stage(Smem& sm, const Args& a, int lane,
                                      int c, int n, size_t row0, size_t step,
                                      int col0) {
  copy_chunk(sm, a, lane, c, n, row0, step, col0);
  arrive_on_copies(&sm.landed[c % RING]);
}

// The producer warp's a_t = sum_i r_i (u_i k_i) of the n steps of a landed
// slot, into sm.a[slot]: AL lanes a step, lane s summing the rows
// 4 (s + 8 m) + e (m = 0, 1; e = 0..3) in that order in BonusT, the lanes'
// sums added by a butterfly, then rounded to f32 once. Its T / 4 passes of
// four steps run side by side.
__device__ __forceinline__ void bonus(Smem& sm, int lane, int slot, int n) {
  constexpr int P = (T + 32 / AL - 1) / (32 / AL);  // passes
  const int sub = lane % AL;
  BonusT part[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int t = j * (32 / AL) + lane / AL;
    part[j] = 0;
    if (j * (32 / AL) < n && t < n) {
#pragma unroll
      for (int m = 0; m < HD / 4 / AL; ++m) {
        const int g4 = sub + AL * m;
        const float4 r4 = sm.r[slot][t][g4], k4 = sm.k[slot][t][g4];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[j] = fma_rn(BonusT(rr[e]),
                           mul_rn(sm.u[4 * g4 + e], BonusT(kk[e])), part[j]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < AL; o <<= 1)
#pragma unroll
    for (int j = 0; j < P; ++j)
      part[j] = add_rn(part[j], __shfl_xor_sync(0xffffffffu, part[j], o));
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int t = j * (32 / AL) + lane / AL;
    if (t < n && sub == 0) sm.a[slot][t] = static_cast<float>(part[j]);
  }
}

// Steps t .. t + NS - 1 of a staged chunk on the lane's state: r0 points
// at the chunk's step t, row group q, v0 at step t, column group cg, a0 at
// a_t, y0 at y of step t, column mine (the lane's after the
// reduce-scatter). Register cc of the lane's columns holds column cc ^ mine
// of its group, so that every stage of the reduce-scatter keeps the lower
// half of the registers and sends the upper half, with no select. The
// steps' state updates run in order; their partial sums of y are
// independent, so their shuffles interleave and share one latency.
template <int NS>
__device__ __forceinline__ void group(const float4* r0, const float4* k0,
                                      const float4* w0, const float* v0,
                                      const float* a0, float* y0, int step,
                                      float (&st)[CPL][HD / LPC], int q,
                                      int mine, uint64_t* summed,
                                      int parity) {
  float vj[NS][CPL], acc[NS][CPL];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      vj[s][cc] = v0[s * CB + (cc ^ mine)];
      acc[s][cc] = 0.0f;
    }
#pragma unroll
    for (int p = 0; p < NG4; ++p) {
      const int i4 = s * (HD / 4) + p * LPC;
      const float4 r4 = r0[i4];
      const float4 k4 = k0[i4], w4 = w0[i4];
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          float& x = st[cc][4 * p + e];
          const float kv = __fmul_rn(kk[e], vj[s][cc]);
          acc[s][cc] = __fmaf_rn(rr[e], x, acc[s][cc]);
          x = __fmaf_rn(ww[e], x, kv);
        }
      }
    }
  }
  // y_j sums the LPC lanes' partial sums: a reduce-scatter, each stage
  // halving the columns a lane holds (xor 1 first, so four lanes add
  // (p0 + p1) + (p2 + p3)), then a butterfly over the lanes left
#pragma unroll
  for (int o = 1, w = CPL; o < LPC; o <<= 1) {
    const int h = w > 1 ? w / 2 : 0;  // the registers sent
    w = w > 1 ? w / 2 : 1;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < w; ++i)
        acc[s][i] = __fadd_rn(
            acc[s][i], __shfl_xor_sync(0xffffffffu, acc[s][h + i], o));
  }
  if (summed != nullptr) bar_wait(summed, parity);  // a_t is summed
#pragma unroll
  for (int s = 0; s < NS; ++s, y0 += step) {
    const float yj = __fmaf_rn(vj[s][0], a0[s], acc[s][0]);
    if (q < CPL) *y0 = yj;
  }
}

// The n steps of the chunk in ring slot `slot`, U at a time; y0 points at
// y of the chunk's first step, the lane's column. The slot's a_t is waited
// for only where the first y needs it.
__device__ __forceinline__ void steps(Smem& sm, float* y0, int step,
                                      float (&st)[CPL][HD / LPC], int slot,
                                      int parity, int n, int q, int cg,
                                      int mine) {
  uint64_t* summed = &sm.summed[slot];
  const float4* r0 = &sm.r[slot][0][q];
  const float4* k0 = &sm.k[slot][0][q];
  const float4* w0 = &sm.w[slot][0][q];
  const float* v0 = &sm.v[slot][0][cg * CPL];
  const float* a0 = sm.a[slot];
  int t = 0;
  for (; t + U <= n; t += U, y0 += U * step, summed = nullptr)
    group<U>(r0 + t * (HD / 4), k0 + t * (HD / 4), w0 + t * (HD / 4),
             v0 + t * CB, a0 + t, y0, step, st, q, mine, summed, parity);
  for (; t < n; ++t, y0 += step, summed = nullptr)
    group<1>(r0 + t * (HD / 4), k0 + t * (HD / 4), w0 + t * (HD / 4),
             v0 + t * CB, a0 + t, y0, step, st, q, mine, summed, parity);
}

__global__ void __launch_bounds__(NT + 32) wkv6_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int grp = blockIdx.x % G, bh = blockIdx.x / G;  // (b * H + h) G + g
  const int h = bh % a.H, b = bh / a.H;
  const int col0 = grp * CB;
  const size_t step = (size_t)a.H * HD;                  // t -> t + 1
  const size_t base = ((size_t)b * a.S * a.H + h) * HD;  // (b, 0, h, 0)
  const size_t chunk = T * step;
  const int nch = (a.S + T - 1) / T;
  const int last = a.S - (nch - 1) * T;  // steps of the last chunk
  auto len = [&](int c) { return c + 1 < nch ? T : last; };

  // the first copies go out before the barriers exist: the state's by the
  // compute threads, chunk 0's by the producer warp
  const size_t s0 = (size_t)bh * HD * HD + col0;
  if (threadIdx.x < NT && a.s_in != nullptr) {
    for (int i = threadIdx.x; i < HD * CB / 4; i += NT)
      cp16(&sm.s[i / (CB / 4)][4 * (i % (CB / 4))],
           a.s_in + s0 + (size_t)(i / (CB / 4)) * HD + 4 * (i % (CB / 4)));
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float u0 = 0.0f, u1 = 0.0f;  // the producer's lanes' bonus weights
  if (threadIdx.x >= NT) {
    const int lane = threadIdx.x - NT;
    u0 = a.u[h * HD + lane];
    u1 = a.u[h * HD + 32 + lane];
    copy_chunk(sm, a, lane, 0, len(0), base, step, col0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      bar_init(&sm.landed[i], 32);
      bar_init(&sm.summed[i], 32);
      bar_init(&sm.freed[i], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NT) {
    // the producer warp: copies AHEAD chunks ahead of its a_t, and a_t of
    // chunk c while the others run an earlier one; a slot is copied into
    // again once the compute warps have freed it
    const int lane = threadIdx.x - NT;
    arrive_on_copies(&sm.landed[0]);
    for (int c = 1; c < AHEAD && c < nch; ++c)
      stage(sm, a, lane, c, len(c), base + c * chunk, step, col0);
    sm.u[lane] = BonusT(u0);
    sm.u[32 + lane] = BonusT(u1);
    __syncwarp();
    for (int c = 0; c < nch; ++c) {
      const int ca = c + AHEAD;
      if (ca < nch) {
        if (ca >= RING) bar_wait(&sm.freed[ca % RING], (ca / RING - 1) & 1);
        stage(sm, a, lane, ca, len(ca), base + ca * chunk, step, col0);
      }
      bar_wait(&sm.landed[c % RING], (c / RING) & 1);
      bonus(sm, lane, c % RING, len(c));
      bar_arrive(&sm.summed[c % RING]);
    }
    return;
  }

  const int q = threadIdx.x % LPC, cg = threadIdx.x / LPC;
  // after the reduce-scatter lane q < CPL holds column `mine` of its
  // group: the half kept at each halving is the upper one where q's bit is
  // set
  int mine = 0;
#pragma unroll
  for (int o = 1, hf = CPL / 2; hf > 0; o <<= 1, hf >>= 1)
    if (q & o) mine += hf;

  // the block's state columns pass through shared memory as 16-byte rows;
  // register cc holds column cg CPL + (cc ^ mine) of them, rows
  // 4 (p LPC + q) + e
  float st[CPL][HD / LPC];
  if (a.s_in != nullptr) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // compute only
  }
#pragma unroll
  for (int p = 0; p < NG4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        st[cc][4 * p + e] =
            a.s_in == nullptr
                ? 0.0f
                : sm.s[4 * (p * LPC + q) + e][cg * CPL + (cc ^ mine)];

  for (int c = 0; c < nch; ++c) {
    const int slot = c % RING, parity = (c / RING) & 1;
    bar_wait(&sm.landed[slot], parity);
    steps(sm, a.y + base + c * chunk + col0 + cg * CPL + mine,
          static_cast<int>(step), st, slot, parity, len(c), q, cg, mine);
    bar_arrive(&sm.freed[slot]);
  }
#pragma unroll
  for (int p = 0; p < NG4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        sm.s[4 * (p * LPC + q) + e][cg * CPL + (cc ^ mine)] =
            st[cc][4 * p + e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // compute only
  for (int i = threadIdx.x; i < HD * CB / 4; i += NT)
    *reinterpret_cast<float4*>(a.s_out + s0 + (size_t)(i / (CB / 4)) * HD +
                               4 * (i % (CB / 4))) =
        *reinterpret_cast<const float4*>(
            &sm.s[i / (CB / 4)][4 * (i % (CB / 4))]);
}

cudaError_t set_smem() {
  if (sizeof(Smem) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(wkv6_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sizeof(Smem));
}

}  // namespace

// y and the final state of the WKV6 recurrence over S steps (see above):
// r, k, v, w, y [B, S, H, hd]; u [H, hd]; s_in (null: zeros) and s_out
// [B, H, hd, hd], all f32 and contiguous, all but u 16-byte aligned.
// Takes hd = 64 and S >= 1 only. Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* y, void* s_out, int B, int S, int H, int hd,
                           void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  if (hd != HD || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {r, k, v, w, s_in, static_cast<const void*>(y),
                        static_cast<const void*>(s_out)})
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B == 0 || H == 0) return 0;
  const cudaError_t e = set_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(r),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(w),
               static_cast<const float*>(u),    static_cast<const float*>(s_in),
               static_cast<float*>(y),          static_cast<float*>(s_out),
               S,                               H};
  wkv6_kernel<<<B * H * G, NT + 32, sizeof(Smem),
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The design and what the card keeps resident of it, into out[9]: G, T,
// CPL, LPC, threads a block, shared bytes a block, resident blocks an SM
// (the occupancy calculator), registers a thread, local (spill) bytes a
// thread. Returns 0 or the CUDA error.
extern "C" int wkv6_occupancy(int* out, void* /*stream*/) {
  cudaError_t e = set_smem();
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wkv6_kernel, NT + 32, sizeof(Smem));
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, wkv6_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[9] = {G,      T,       CPL,        LPC,
                       NT + 32, static_cast<int>(sizeof(Smem)), blocks,
                       fa.numRegs, static_cast<int>(fa.localSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}
