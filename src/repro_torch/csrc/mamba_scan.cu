// Selective SSM scan for Hopper (sm_90a), plain C interface:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = C_t . h_t
// per (batch, channel), from h_0 = 0, and the final state h_S.
//
// Replaces the Pallas kernel repro/kernels/mamba_scan.py::_mamba_kernel (K6),
// the scan of hymba's parallel Mamba branch (repro/models/ssm.py
// _mamba_inner). The Pallas grid walks the sequence as its sequential third
// axis and revisits the state block in VMEM; here the sequence is a loop
// inside the block and the state never leaves registers.
//
// Layout: each (batch, channel) is an independent recurrence over S with an
// N-element state. Every state element has one lane: N lanes per channel,
// CH = 512 / N channels per block of 512 threads, blocks over
// B x ceil(di / CH) (a ragged di is masked: hymba's di = 3200 = 100 x 32).
// The block stages T = 32 steps of dt and x ([T, CH], coalesced rows) and
// of B and C ([T, N]) in shared memory, every lane steps through them with
// h in a register, y_t is summed over the channel's N lanes with xor
// shuffles, and the [T, CH] tile of y goes back coalesced. expf, not
// __expf: K6's f32 tolerance is 2e-5.
//
// What bounds it on an H100: at hymba's prefill (B=4, S=2048, di=3200,
// N=16) 419 M state updates, each an expf (on the special-function units
// and FMA pipes) and three multiply-adds, against ~317 MB of f32 dt, x and
// y; chip_smoke.py computes and reports both bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block
constexpr int TS = 32;   // time steps staged per chunk

template <int N>
__global__ void __launch_bounds__(NT)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ h_out, int S, int di) {
  constexpr int CH = NT / N;  // channels per block
  __shared__ float s_dt[TS][CH];
  __shared__ float s_x[TS][CH];
  __shared__ float s_y[TS][CH];
  __shared__ float s_b[TS][N];
  __shared__ float s_c[TS][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int n = tid % N;          // this lane's state element
  const int ch = tid / N;         // this lane's channel in the block
  const int c = c0 + ch;
  const bool live = c < di;
  const float a_n = live ? a[(size_t)c * N + n] : 0.0f;
  float h = 0.0f;

  const size_t row0 = (size_t)b * S;  // first row of this batch element
  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    for (int i = tid; i < TS * CH; i += NT) {
      const int t = i / CH, cc = i % CH;
      const bool ok = t < steps && c0 + cc < di;
      const size_t off = (row0 + t0 + t) * di + c0 + cc;
      s_dt[t][cc] = ok ? dt[off] : 0.0f;
      s_x[t][cc] = ok ? x[off] : 0.0f;
    }
    for (int i = tid; i < TS * N; i += NT) {
      const int t = i / N, nn = i % N;
      const bool ok = t < steps;
      const size_t off = (row0 + t0 + t) * N + nn;
      s_b[t][nn] = ok ? bm[off] : 0.0f;
      s_c[t][nn] = ok ? cm[off] : 0.0f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float d = s_dt[t][ch];
      h = expf(d * a_n) * h + (d * s_x[t][ch]) * s_b[t][n];
      float p = h * s_c[t][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) s_y[t][ch] = p;
    }
    __syncthreads();
    for (int i = tid; i < TS * CH; i += NT) {
      const int t = i / CH, cc = i % CH;
      if (t < steps && c0 + cc < di)
        y[(row0 + t0 + t) * di + c0 + cc] = s_y[t][cc];
    }
    __syncthreads();  // the next chunk overwrites the staged tiles
  }
  if (live) h_out[((size_t)b * di + c) * N + n] = h;
}

template <int N>
void launch(const float* dt, const float* x, const float* bm, const float* cm,
            const float* a, float* y, float* h, int B, int S, int di,
            cudaStream_t stream) {
  constexpr int CH = NT / N;
  const dim3 grid((di + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, NT, 0, stream>>>(dt, x, bm, cm, a, y, h, S, di);
}

}  // namespace

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok).
// All f32, contiguous: dt, x, y [B, S, di]; bm, cm [B, S, N]; a [di, N];
// h [B, di, N] receives the final state. N is 8 or 16 (the wrapper
// checks). Nothing is allocated here.
extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* bm,
                                 const void* cm, const void* a, void* y,
                                 void* h, int B, int S, int di, int N,
                                 void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_x = static_cast<const float*>(x);
  const float* f_b = static_cast<const float*>(bm);
  const float* f_c = static_cast<const float*>(cm);
  const float* f_a = static_cast<const float*>(a);
  float* f_y = static_cast<float*>(y);
  float* f_h = static_cast<float*>(h);
  if (N == 16)
    launch<16>(f_dt, f_x, f_b, f_c, f_a, f_y, f_h, B, S, di, s);
  else if (N == 8)
    launch<8>(f_dt, f_x, f_b, f_c, f_a, f_y, f_h, B, S, di, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
