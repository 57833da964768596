// Selective SSM scan for Hopper (sm_90a), plain C interface:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = C_t . h_t
// per (batch, channel), from h_0 = 0, and the final state h_S. The fused
// entry also computes the scan's neighbours in hymba's Mamba branch
// (repro_torch/models/ssm.py::_mamba_inner), with their rounding points:
//   dt  = softplus(dt_lin + dt_bias)               (f32, before the scan)
//   out = ((y + d_skip * x) * silu(z)) in x's type (f32 math, after it)
//
// Replaces the Pallas kernel repro/kernels/mamba_scan.py::_mamba_kernel (K6),
// which fuses the decay and input terms in VMEM; the fused entry carries
// that move on to the f32 passes around the scan, so per element the
// kernel reads dt_lin (4 B), x and z (2 B each at bf16) and writes y (2 B),
// and no [B, S, di] f32 intermediate goes through device memory.
//
// Layout: each (batch, channel) is an independent recurrence over S with an
// N-element state. A lane holds P = 4 states of one channel in registers,
// so N / 4 lanes share a channel (neighbouring lanes). A block of NT threads
// takes CH = 4 NT / N channels of one batch element and walks the sequence
// in chunks of TS steps, staged in shared memory by cp.async (16-byte
// copies; element loads where a row is not 16-byte aligned) through a ring
// of four chunks: while chunk k scans, chunk k + 2 arrives, chunk k + 1
// waits for its prologue and chunk k - 1 for its epilogue. Per element, once
// per (t, channel) and not per lane:
//   prologue: (dt, dt * x) into shared memory, dt through the bias and
//             softplus when fused;
//   epilogue: y_t as the sum of the channel's lanes' partial sums, skip,
//             gate and rounding, y stored row-coalesced.
// Each thread's share of chunk k + 1's prologue and of chunk k - 1's
// epilogue is interleaved into the steps of chunk k's scan, which they do
// not depend on, so a chunk costs one barrier. Even and odd chunks keep
// their (dt, dt * x) and partial sums in separate members and the chunk
// loop is unrolled by two, so the compiler can tell the scan's loads from
// the stores beside them and hoist them. Per step and lane the scan does
// one 8-byte and two 16-byte shared loads, four expf and 16 FMA-pipe
// operations and one shared store of its partial sum of y_t. The decay is
// the accurate expf (eight instructions, one of them an ex2.approx on the
// reduced argument): __expf, one ex2.approx.ftz on dt * a * log2 e, misses
// K6's 2e-5 gate at hymba's prefill shape, its error near 1 adding up over a
// state's long memory (tools/k6_variants.py measures both). softplus and
// silu are branch-free forms within a few f32 ulps of PyTorch's (below).
//
// What bounds it on an H100: at hymba's prefill (B=4, S=2048, di=3200,
// N=16) 419 M state updates, each an exp on the special-function units (16
// per clock per SM), against 264 MB of bf16 / f32 traffic fused or 317 MB
// of f32 unfused; chip_smoke.py computes and reports the bounds. The
// instruction rate binds first: about 25 instructions per state update, at
// 256 threads a block, 2 blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int P = 4;     // states per lane
constexpr int NT = 256;  // threads per block
constexpr int TS = 16;   // time steps per staged chunk
constexpr int RING = 4;  // staged chunks

// softplus(v) = logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|)), with
// log1p(u) = 2 atanh(s), s = u / (2 + u) <= 1/3, by its odd series to s^15:
// no branch, within a few f32 ulps of PyTorch's log1pf form
__device__ __forceinline__ float softplus(float v) {
  const float u = expf(-fabsf(v));
  const float s = __fdividef(u, 2.0f + u), s2 = s * s;
  float p = fmaf(s2, 1.0f / 15.0f, 1.0f / 13.0f);
  p = fmaf(s2, p, 1.0f / 11.0f);
  p = fmaf(s2, p, 1.0f / 9.0f);
  p = fmaf(s2, p, 1.0f / 7.0f);
  p = fmaf(s2, p, 1.0f / 5.0f);
  p = fmaf(s2, p, 1.0f / 3.0f);
  return fmaxf(v, 0.0f) + 2.0f * fmaf(s * s2, p, s);
}

// silu(z) = z / (1 + exp(-z)); the division without IEEE rounding's slow
// path (2 ulps; 0 where 1 + exp(-z) > 2^126, for z < -87)
__device__ __forceinline__ float silu(float z) {
  return __fdividef(z, 1.0f + expf(-z));
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0));
}

template <typename TX>
struct Args {
  const float* dt;     // [B, S, di]: dt, or dt_lin when fused
  const float* bias;   // [di] (fused)
  const TX* x;         // [B, S, di]
  const TX* z;         // rows of zs elements (fused)
  const float* dskip;  // [di] (fused)
  const float* bm;     // rows of bs elements, N used
  const float* cm;     // rows of cs elements, N used
  const float* a;      // [di, N]
  TX* y;               // [B, S, di]
  float* h;            // [B, di, N]
  int S, di, zs, bs, cs;
};

template <int N, bool FUSED, typename TX>
struct Smem {
  static constexpr int L = N / P;    // lanes per channel
  static constexpr int CH = NT / L;  // channels per block
  float dt[RING][TS][CH];            // as staged
  TX x[RING][TS][CH];
  TX z[FUSED ? RING : 1][FUSED ? TS : 1][FUSED ? CH : 1];
  float4 b[RING][TS][N / 4];
  float4 c[RING][TS][N / 4];
  // (dt, dt * x) and the lanes' partial sums of y, of even and of odd
  // chunks: separate members, so that the compiler sees the scan's loads
  // apart from the stores made beside them
  float2 dd0[TS][CH], dd1[TS][CH];
  float y0[TS][CH][L], y1[TS][CH][L];
};

// the even (PAR 0) or odd (PAR 1) chunk's member
template <int PAR, typename T>
__device__ __forceinline__ T& pick(T& even, T& odd) {
  if constexpr (PAR == 0) return even;
  else return odd;
}

// chunk rows [t0, t0 + TS) of block (b, c0) into ring slot `buf`
template <int N, bool FUSED, bool VEC, typename TX>
__device__ __forceinline__ void stage(Smem<N, FUSED, TX>& sm, int buf,
                                      const Args<TX>& g, size_t rowb, int c0,
                                      int t0) {
  constexpr int CH = Smem<N, FUSED, TX>::CH;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int XV = 16 / sizeof(TX);  // x elements per 16 bytes
    for (int i = tid; i < TS * CH / 4; i += NT) {
      const int t = i / (CH / 4), c = c0 + 4 * (i % (CH / 4));
      const bool in = t0 + t < g.S && c < g.di;
      cp16(&sm.dt[buf][t][c - c0],
           in ? g.dt + (rowb + t0 + t) * g.di + c : g.dt, in);
    }
    for (int i = tid; i < TS * CH / XV; i += NT) {
      const int t = i / (CH / XV), c = c0 + XV * (i % (CH / XV));
      const bool in = t0 + t < g.S && c < g.di;
      cp16(&sm.x[buf][t][c - c0],
           in ? g.x + (rowb + t0 + t) * g.di + c : g.x, in);
      if constexpr (FUSED)
        cp16(&sm.z[buf][t][c - c0],
             in ? g.z + (rowb + t0 + t) * g.zs + c : g.z, in);
    }
    for (int i = tid; i < TS * N / 4; i += NT) {
      const int t = i / (N / 4), v = i % (N / 4);
      const bool in = t0 + t < g.S;
      cp16(&sm.b[buf][t][v], in ? g.bm + (rowb + t0 + t) * g.bs + 4 * v
                                : g.bm, in);
      cp16(&sm.c[buf][t][v], in ? g.cm + (rowb + t0 + t) * g.cs + 4 * v
                                : g.cm, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = tid; i < TS * CH; i += NT) {
      const int t = i / CH, cc = i % CH, c = c0 + cc;
      const bool in = t0 + t < g.S && c < g.di;
      const size_t r = rowb + t0 + t;
      sm.dt[buf][t][cc] = in ? g.dt[r * g.di + c] : 0.0f;
      sm.x[buf][t][cc] = in ? g.x[r * g.di + c] : from_f32<TX>(0.0f);
      if constexpr (FUSED)
        sm.z[buf][t][cc] = in ? g.z[r * g.zs + c] : from_f32<TX>(0.0f);
    }
    for (int i = tid; i < TS * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool in = t0 + t < g.S;
      const size_t r = rowb + t0 + t;
      reinterpret_cast<float*>(sm.b[buf][t])[n] = in ? g.bm[r * g.bs + n]
                                                     : 0.0f;
      reinterpret_cast<float*>(sm.c[buf][t])[n] = in ? g.cm[r * g.cs + n]
                                                     : 0.0f;
    }
  }
}

template <int N, bool FUSED, bool VEC, typename TX>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const Args<TX> g) {
  using SM = Smem<N, FUSED, TX>;
  constexpr int L = SM::L, CH = SM::CH;
  constexpr int E = TS * CH / NT;  // prologue / epilogue elements a thread
  constexpr int SP = TS / E;       // ... has per chunk: one per SP steps
  static_assert(P % 4 == 0 && N % P == 0 && NT % CH == 0 && CH % 8 == 0 &&
                    TS % E == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);

  const int b = blockIdx.y, c0 = blockIdx.x * CH, tid = threadIdx.x;
  // the scan's lane: states q * P .. q * P + P - 1 of channel c0 + ch
  const int q = tid % L, ch = tid / L;
  const bool live = c0 + ch < g.di;
  float a[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p] = live ? g.a[(size_t)(c0 + ch) * N + q * P + p] : 0.0f;
    h[p] = 0.0f;
  }
  // the prologue's and epilogue's channel (the same for every element of
  // a thread, as NT % CH == 0) and its rows tid / CH + j * NT / CH
  const int ec = tid % CH, er = tid / CH;
  const bool elive = c0 + ec < g.di;
  float bias = 0.0f, dskip = 0.0f;
  if (FUSED && elive) {
    bias = g.bias[c0 + ec];
    dskip = g.dskip[c0 + ec];
  }
  const size_t rowb = (size_t)b * g.S;

  // prologue element j of the chunk in ring slot `slot`: (dt, dt * x)
  // into dd
  auto prologue = [&](int slot, float2 (&dd)[TS][CH], int j) {
    const int t = er + j * (NT / CH);
    float d = sm.dt[slot][t][ec];
    if constexpr (FUSED) d = elive ? softplus(__fadd_rn(d, bias)) : 0.0f;
    dd[t][ec] = make_float2(d, __fmul_rn(d, to_f32(sm.x[slot][t][ec])));
  };
  // epilogue element j of the chunk in ring slot `slot` at sequence rows
  // row.. (`steps` of them): the lanes' partial sums of y, skip and gate;
  // stored if `on`
  auto epilogue = [&](int slot, const float (&ys)[TS][CH][L], long long row,
                      int steps, bool on, int j) {
    const int t = er + j * (NT / CH);
    float v = ys[t][ec][0];
#pragma unroll
    for (int l = 1; l < L; ++l) v += ys[t][ec][l];
    if constexpr (FUSED) {
      const float xv = to_f32(sm.x[slot][t][ec]);
      v = __fmul_rn(__fadd_rn(v, __fmul_rn(dskip, xv)),
                    silu(to_f32(sm.z[slot][t][ec])));
    }
    if (on && elive && t < steps)
      g.y[(row + t) * g.di + c0 + ec] = from_f32<TX>(v);
  };
  // scan step t of the chunk in ring slot `slot`, (dt, dt * x) from dd, the
  // lane's partial sum of y_t into ys
  auto step = [&](int slot, const float2 (&dd)[TS][CH],
                  float (&ys)[TS][CH][L], int t) {
    const float2 d = dd[t][ch];
    float bb[P], cc[P];
#pragma unroll
    for (int v = 0; v < P / 4; ++v) {
      const float4 bv = sm.b[slot][t][q * (P / 4) + v];
      const float4 cv = sm.c[slot][t][q * (P / 4) + v];
      bb[4 * v] = bv.x, bb[4 * v + 1] = bv.y, bb[4 * v + 2] = bv.z,
      bb[4 * v + 3] = bv.w;
      cc[4 * v] = cv.x, cc[4 * v + 1] = cv.y, cc[4 * v + 2] = cv.z,
      cc[4 * v + 3] = cv.w;
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      h[p] = fmaf(expf(d.x * a[p]), h[p], d.y * bb[p]);
    float yp = h[0] * cc[0];
#pragma unroll
    for (int p = 1; p < P; ++p) yp = fmaf(h[p], cc[p], yp);
    ys[t][ch][q] = yp;
  };
  const int chunks = (g.S + TS - 1) / TS;
  // chunk k, of parity PAR = k & 1. At the start: its (dt, dt * x) in its
  // dd, chunk k + 1 staged, chunk k - 1's partial sums in the other y
  auto chunk = [&](int k, auto par) {
    constexpr int PAR = decltype(par)::value;
    float2(&dd)[TS][CH] = pick<PAR>(sm.dd0, sm.dd1);
    float2(&dd_next)[TS][CH] = pick<PAR>(sm.dd1, sm.dd0);
    float(&ys)[TS][CH][L] = pick<PAR>(sm.y0, sm.y1);
    const float(&ys_last)[TS][CH][L] = pick<PAR>(sm.y1, sm.y0);
    const int slot = k % RING, t0 = k * TS;
    const int nslot = (k + 1) % RING, pslot = (k + RING - 1) % RING;
    const long long prow = (long long)rowb + t0 - TS;
    if (k + 2 < chunks)
      stage<N, FUSED, VEC>(sm, (k + 2) % RING, g, rowb, c0, t0 + 2 * TS);
    if (t0 + TS <= g.S) {
      // chunk k + 1's prologue (a dead store past the last chunk) and
      // chunk k - 1's epilogue (nothing stored for k = 0), between the
      // steps, which they do not depend on
#pragma unroll
      for (int t = 0; t < TS; ++t) {
        step(slot, dd, ys, t);
        if (t % SP == 0) prologue(nslot, dd_next, t / SP);
        if (t % SP == SP / 2)
          epilogue(pslot, ys_last, prow, TS, k > 0, t / SP);
      }
    } else {  // the last chunk, short
      for (int t = 0; t < g.S - t0; ++t) step(slot, dd, ys, t);
#pragma unroll
      for (int j = 0; j < E; ++j)
        epilogue(pslot, ys_last, prow, TS, k > 0, j);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };

  stage<N, FUSED, VEC>(sm, 0, g, rowb, c0, 0);
  if (chunks > 1) stage<N, FUSED, VEC>(sm, 1, g, rowb, c0, TS);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) prologue(0, sm.dd0, j);
  __syncthreads();
  for (int k = 0; k < chunks; k += 2) {
    chunk(k, std::integral_constant<int, 0>());
    if (k + 1 < chunks) chunk(k + 1, std::integral_constant<int, 1>());
  }
  const int last = chunks - 1;
  const float(&ys_last)[TS][CH][L] = last & 1 ? sm.y1 : sm.y0;
#pragma unroll
  for (int j = 0; j < E; ++j)
    epilogue(last % RING, ys_last, (long long)rowb + last * TS,
             g.S - last * TS, true, j);
  if (live) {
    float4* ho = reinterpret_cast<float4*>(
        g.h + ((size_t)b * g.di + c0 + ch) * N + q * P);
#pragma unroll
    for (int v = 0; v < P / 4; ++v)
      ho[v] = make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
  }
}

template <int N, bool FUSED, bool VEC, typename TX>
int launch(const Args<TX>& g, int B, cudaStream_t s) {
  using SM = Smem<N, FUSED, TX>;
  auto kern = mamba_scan_kernel<N, FUSED, VEC, TX>;
  if (sizeof(SM) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(SM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((g.di + SM::CH - 1) / SM::CH, B);
  kern<<<grid, NT, sizeof(SM), s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// resident blocks per SM of one instance (0 where it cannot launch)
template <int N, bool FUSED, typename TX>
int blocks_per_sm() {
  using SM = Smem<N, FUSED, TX>;
  auto kern = mamba_scan_kernel<N, FUSED, true, TX>;
  if (sizeof(SM) > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sizeof(SM)) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT,
                                                    sizeof(SM)) != cudaSuccess)
    return 0;
  return n;
}

template <bool FUSED, typename TX>
int dispatch(const Args<TX>& g, int B, int N, cudaStream_t s) {
  const bool vec = g.di % 8 == 0 && g.bs % 4 == 0 && g.cs % 4 == 0 &&
                   aligned16(g.dt) && aligned16(g.x) && aligned16(g.bm) &&
                   aligned16(g.cm) &&
                   (!FUSED || (g.zs % 8 == 0 && aligned16(g.z)));
  if (N == 16)
    return vec ? launch<16, FUSED, true>(g, B, s)
               : launch<16, FUSED, false>(g, B, s);
  if (N == 8)
    return vec ? launch<8, FUSED, true>(g, B, s)
               : launch<8, FUSED, false>(g, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// dt [B, S, di] f32 contiguous: dt itself, or dt_lin when fused = 1; x, y
// [B, S, di] contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1, fused only);
// bm, cm: [B, S, N] f32 rows of bs / cs elements (unit stride within a
// row); a [di, N] f32; h [B, di, N] f32 receives the final state. Fused:
// bias, dskip [di] f32 and z rows of zs elements in x's type; else they
// are null. N is 8 or 16. Nothing is allocated here.
extern "C" int mamba_scan_launch(const void* dt, const void* bias,
                                 const void* x, const void* z,
                                 const void* dskip, const void* bm,
                                 const void* cm, const void* a, void* y,
                                 void* h, int B, int S, int di, int N,
                                 int zs, int bs, int cs, int fused, int bf16,
                                 void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  if (B == 0 || di == 0) return 0;
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(dt);
  const float* fb = static_cast<const float*>(bias);
  const float* fd = static_cast<const float*>(dskip);
  const float* fbm = static_cast<const float*>(bm);
  const float* fcm = static_cast<const float*>(cm);
  const float* fa = static_cast<const float*>(a);
  float* fh = static_cast<float*>(h);
  if (bf16) {
    if (!fused) return static_cast<int>(cudaErrorInvalidValue);
    using T = __nv_bfloat16;
    const Args<T> g{f, fb, static_cast<const T*>(x), static_cast<const T*>(z),
                    fd, fbm, fcm, fa, static_cast<T*>(y), fh, S, di, zs, bs,
                    cs};
    return dispatch<true>(g, B, N, s);
  }
  const Args<float> g{f, fb, static_cast<const float*>(x),
                      static_cast<const float*>(z), fd, fbm, fcm, fa,
                      static_cast<float*>(y), fh, S, di, zs, bs, cs};
  return fused ? dispatch<true>(g, B, N, s) : dispatch<false>(g, B, N, s);
}

// The occupancy the 16-byte-staged instance of (N, fused, bf16) can reach:
// blocks per SM, its threads per block and its shared memory per block
// written to out[0..2] (host memory). The stream is not used. Returns
// cudaGetLastError() (0 = ok).
extern "C" int mamba_scan_occupancy(void* out, int N, int fused, int bf16,
                                    void* stream) {
  (void)stream;
  cudaGetLastError();
  int* o = static_cast<int*>(out);
  using T = __nv_bfloat16;
  if (N == 16 && fused && bf16) {
    o[0] = blocks_per_sm<16, true, T>();
    o[2] = sizeof(Smem<16, true, T>);
  } else if (N == 16 && fused) {
    o[0] = blocks_per_sm<16, true, float>();
    o[2] = sizeof(Smem<16, true, float>);
  } else if (N == 16 && !bf16) {
    o[0] = blocks_per_sm<16, false, float>();
    o[2] = sizeof(Smem<16, false, float>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  o[1] = NT;
  return static_cast<int>(cudaGetLastError());
}
