// Row gather for Hopper (sm_90a), plain C interface: out[i] = y[idx[i]],
// and its backward, dx[j] = sum of dy[i] over the i with idx[i] = j.
//
// Replaces the Pallas kernel repro/kernels/condense.py::_gather_kernel (K3),
// the un-condense step of token condensation (paper §VI, token_to_token):
// every condensed token takes its representative's row. Rows are copied as
// raw bytes, so the result is bit for bit the source row whatever its type
// (bf16 or f32).
//
// Design: one block of 256 threads per tile of 8 rows (one warp per row),
// so that at moe-gpt2's 8192 rows every row's copy is in flight at once
// (1024 blocks, 8 per SM). A warp copies its row in 16-byte vectors when
// the row's bytes and both base pointers allow it, else in 4- or 2-byte
// words (the wrapper picks the widest width that divides the row and the
// alignment). Lane 0 reads the row's index (int32 or int64, as the caller
// holds it) and hands it to the warp; then each lane issues every load of
// its words before its first store, unrolled by the row's width (3 vectors
// a lane at d = 768 in bf16), so a row's bytes are in flight together.
//
// The backward is the port's own: the reference's gradient is XLA's
// transpose of jnp.take. It is a segmented sum, not a scatter-add: row j
// of dx is the f32 sum of the dy rows i with idx[i] = j, in ascending i,
// written once in dy's type. No atomics, so a run repeats bit for bit, and
// the sums equal index_add_'s on the CPU, which adds in index order too.
// Two entries:
//   * general (gather_rows_bwd_launch, any map): the wrapper sorts idx
//     stably (order) and finds where each destination's run of sources
//     starts (start, n_dst + 1 entries); one warp per destination row adds
//     its sources' rows.
//   * group-local (gather_rows_bwd_grouped_launch): the un-condense map
//     sends every token to a row of its own group of G (condensation's
//     groups), so the sort is a block's work. One block per (group, column
//     chunk of 8 copy words): it reads the group's G indices, counts each
//     destination's sources and places them stably in shared memory (no
//     global sort, no host step); it copies the group's [G x chunk] slab
//     of dy into shared memory with every load in flight at once; then
//     each thread sums the sources of one (destination row, copy word) in
//     ascending order from shared memory and writes that word once. A row
//     with no sources is written as zeros. An index outside its own group
//     traps. Its sums are the general entry's, in the same order: bit for
//     bit the same dx.
//
// What bounds all three on an H100: bytes. At moe-gpt2's full train width
// (T = 8192 rows of d = 768 bf16) one launch reads and writes 12.6 MB
// each, about 7.5 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 8;  // rows per block, one warp each
constexpr int NT = 32 * ROWS;

// N: copy words per lane and pass (a row of at most 32 N words is one
// pass); I: the index type.
template <typename V, int N, typename I>
__global__ void __launch_bounds__(NT)
gather_kernel(const V* __restrict__ y, const I* __restrict__ idx,
              V* __restrict__ out, int T, int n_src, int vec_per_row) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= T) return;   // uniform over the warp
  int64_t src = 0;
  if (lane == 0) src = static_cast<int64_t>(idx[row]);
  src = __shfl_sync(0xffffffffu, src, 0);
  if (src < 0 || src >= n_src) __trap();  // an index out of range is a bug
  const V* s = y + (size_t)src * vec_per_row;
  V* o = out + (size_t)row * vec_per_row;
  for (int v0 = 0; v0 < vec_per_row; v0 += 32 * N) {
    V buf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = v0 + lane + 32 * i;
      if (v < vec_per_row) buf[i] = s[v];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int v = v0 + lane + 32 * i;
      if (v < vec_per_row) o[v] = buf[i];
    }
  }
}

template <typename V, typename I>
void launch(const void* y, const void* idx, void* out, int T, int n_src,
            int row_bytes, cudaStream_t stream) {
  const int vec = row_bytes / (int)sizeof(V);
  const int passes = (vec + 31) / 32;   // words per lane for one pass
  const dim3 grid((T + ROWS - 1) / ROWS);
  const V* ty = static_cast<const V*>(y);
  const I* ti = static_cast<const I*>(idx);
  V* to = static_cast<V*>(out);
  if (passes <= 1)
    gather_kernel<V, 1, I><<<grid, NT, 0, stream>>>(ty, ti, to, T, n_src, vec);
  else if (passes == 2)
    gather_kernel<V, 2, I><<<grid, NT, 0, stream>>>(ty, ti, to, T, n_src, vec);
  else if (passes == 3)
    gather_kernel<V, 3, I><<<grid, NT, 0, stream>>>(ty, ti, to, T, n_src, vec);
  else if (passes == 4)
    gather_kernel<V, 4, I><<<grid, NT, 0, stream>>>(ty, ti, to, T, n_src, vec);
  else
    gather_kernel<V, 8, I><<<grid, NT, 0, stream>>>(ty, ti, to, T, n_src, vec);
}

template <typename V>
void launch_width(const void* y, const void* idx, int idx64, void* out,
                  int T, int n_src, int row_bytes, cudaStream_t stream) {
  if (idx64)
    launch<V, int64_t>(y, idx, out, T, n_src, row_bytes, stream);
  else
    launch<V, int32_t>(y, idx, out, T, n_src, row_bytes, stream);
}

template <typename T>
__global__ void __launch_bounds__(NT)
segment_sum_kernel(const T* __restrict__ dy, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ start, T* __restrict__ dx,
                   int n_dst, int d) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_dst) return;
  const int64_t b = start[row], e = start[row + 1];
  T* o = dx + (size_t)row * d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.0f;
    for (int64_t k = b; k < e; ++k)
      acc += to_f32(dy[(size_t)order[k] * d + c]);
    o[c] = from_f32<T>(acc);
  }
}


// ---- the group-local backward

constexpr int GROUP_NT = 256;   // threads per (group, chunk) block
constexpr int CHUNK = 8;        // copy words per row in one block
constexpr int MAX_G = 1024;     // largest group (shared memory)

template <typename T, typename V>
__global__ void __launch_bounds__(GROUP_NT)
group_sum_kernel(const V* __restrict__ dy, const int64_t* __restrict__ idx,
                 V* __restrict__ dx, int G, int vec_per_row) {
  constexpr int W = sizeof(V) / sizeof(T);   // elements per copy word
  extern __shared__ int4 smem_i4[];
  V* slab = reinterpret_cast<V*>(smem_i4);                   // [G][CHUNK]
  int* dst = reinterpret_cast<int*>(slab + (size_t)G * CHUNK);  // [G]
  int* start = dst + G;                                      // [G]
  int* count = start + G;                                    // [G]
  int* src = count + G;                                      // [G]
  const int64_t g0 = (int64_t)blockIdx.x * G;
  const int v0 = blockIdx.y * CHUNK;
  const int nv = min(CHUNK, vec_per_row - v0);
  const int tid = threadIdx.x;

  // the slab: every load issued before any is waited on
  for (int it = tid; it < G * CHUNK; it += GROUP_NT) {
    const int i = it / CHUNK, v = it % CHUNK;
    if (v < nv) slab[it] = dy[(g0 + i) * vec_per_row + v0 + v];
  }
  for (int i = tid; i < G; i += GROUP_NT) {
    const int64_t j = idx[g0 + i] - g0;
    if (j < 0 || j >= G) __trap();   // a map that leaves its group is a bug
    dst[i] = static_cast<int>(j);
  }
  __syncthreads();
  // destination j's sources start after those of every smaller j
  for (int j = tid; j < G; j += GROUP_NT) {
    int lt = 0, eq = 0;
    for (int i = 0; i < G; ++i) {
      lt += dst[i] < j;
      eq += dst[i] == j;
    }
    start[j] = lt;
    count[j] = eq;
  }
  __syncthreads();
  // source i goes after the sources of its destination that precede it
  for (int i = tid; i < G; i += GROUP_NT) {
    const int j = dst[i];
    int rank = 0;
    for (int k = 0; k < i; ++k) rank += dst[k] == j;
    src[start[j] + rank] = i;
  }
  __syncthreads();

  for (int it = tid; it < G * CHUNK; it += GROUP_NT) {
    const int j = it / CHUNK, v = it % CHUNK;
    if (v >= nv) continue;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    const int b = start[j], e = b + count[j];
    for (int k = b; k < e; ++k) {
      const V raw = slab[src[k] * CHUNK + v];
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] += to_f32(x[w]);
    }
    V o;
    T* y = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int w = 0; w < W; ++w) y[w] = from_f32<T>(acc[w]);
    dx[(g0 + j) * vec_per_row + v0 + v] = o;
  }
}

template <typename T, typename V>
int launch_grouped(const void* dy, const int64_t* idx, void* dx,
                   int n_groups, int G, int row_bytes, cudaStream_t stream) {
  const int vec = row_bytes / (int)sizeof(V);
  const int bytes = G * CHUNK * (int)sizeof(V) + 4 * G * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      group_sum_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_groups, (vec + CHUNK - 1) / CHUNK);
  group_sum_kernel<T, V><<<grid, GROUP_NT, bytes, stream>>>(
      static_cast<const V*>(dy), idx, static_cast<V*>(dx), G, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// idx is [T] into the n_src rows of y, int64 (idx64 = 1) or int32
// (idx64 = 0); row_bytes is one row's size; width is the copy word in
// bytes (16, 4 or 2), which must divide row_bytes and the alignment of y
// and out. Nothing is allocated here.
extern "C" int gather_rows_launch(const void* y, const void* idx, void* out,
                                  int T, int n_src, int row_bytes, int width,
                                  int idx64, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 16)
    launch_width<uint4>(y, idx, idx64, out, T, n_src, row_bytes, s);
  else if (width == 4)
    launch_width<uint32_t>(y, idx, idx64, out, T, n_src, row_bytes, s);
  else if (width == 2)
    launch_width<uint16_t>(y, idx, idx64, out, T, n_src, row_bytes, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream`; returns cudaGetLastError() (0 = ok).
// dy is [T, d] in f32 (bf16 = 0) or bf16 (bf16 = 1); order is int64 [T],
// the stable sort permutation of the forward's idx; start is int64
// [n_dst + 1], where destination j's sources begin in order (start[n_dst]
// = T); dx is [n_dst, d] in dy's type. Nothing is allocated here.
extern "C" int gather_rows_bwd_launch(const void* dy, const void* order,
                                      const void* start, void* dx, int n_dst,
                                      int d, int bf16, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ord = static_cast<const int64_t*>(order);
  const int64_t* st = static_cast<const int64_t*>(start);
  const dim3 grid((n_dst + ROWS - 1) / ROWS);
  if (bf16)
    segment_sum_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), ord, st,
        static_cast<__nv_bfloat16*>(dx), n_dst, d);
  else
    segment_sum_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(dy), ord, st, static_cast<float*>(dx),
        n_dst, d);
  return static_cast<int>(cudaGetLastError());
}

// Launches the group-local backward on `stream`; returns a cudaError_t (0 =
// ok). dy and dx are [n_groups * G, d] in f32 (bf16 = 0) or bf16 (bf16 =
// 1); idx is int64 [n_groups * G], each in its own group: idx[i] / G ==
// i / G. row_bytes is one row's size, width the copy word in bytes (16, 4
// or 2; at least 4 for f32), which must divide row_bytes and the alignment
// of dy and dx. 1 <= G <= 1024. Nothing is allocated here.
extern "C" int gather_rows_bwd_grouped_launch(const void* dy, const void* idx,
                                              void* dx, int n_groups, int G,
                                              int row_bytes, int width,
                                              int bf16, void* stream) {
  cudaGetLastError();  // start from a clean slate; report only our launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  if (G < 1 || G > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (width == 16)
      return launch_grouped<__nv_bfloat16, uint4>(dy, ix, dx, n_groups, G,
                                                  row_bytes, s);
    if (width == 4)
      return launch_grouped<__nv_bfloat16, uint32_t>(dy, ix, dx, n_groups,
                                                     G, row_bytes, s);
    if (width == 2)
      return launch_grouped<__nv_bfloat16, uint16_t>(dy, ix, dx, n_groups,
                                                     G, row_bytes, s);
  } else {
    if (width == 16)
      return launch_grouped<float, uint4>(dy, ix, dx, n_groups, G, row_bytes,
                                          s);
    if (width == 4)
      return launch_grouped<float, uint32_t>(dy, ix, dx, n_groups, G,
                                             row_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
