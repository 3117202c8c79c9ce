// The relation table's gradient: a deterministic split-segment sum,
// hand-written for Hopper (sm_90a).
//
// Replaces no pallas_call: the JAX package gathers rel[etype]
// (complexhyperbolickge_tpu/models/gnn/convs.py) and XLA scatter-adds its
// backward.  The port's autograd would run that backward as index_put_ with
// accumulate: a radix sort of the ids, then one warp per distinct id walking
// all of that id's rows in sequence, so with 22 relation rows at most 22
// warps work on the card's 132 SMs (10.9 ms of a 14.6 ms CompGCN step at
// WN18RR's widths).  Here
//   out[r, :] = sum_{i : ids[i] = r - shift} g[i, :]
// over a STATIC id vector (one sorted half of the full graph's etype), whose
// layout the host builds once (kernels/relgrad.py::RelationLayout): perm,
// the stable permutation sorting the rows by id; chunks (start, end, id),
// runs of at most C consecutive sorted rows of one id; chunk_ptr (n_ids + 1),
// each id's first chunk.
//
// Bound on an H100 SXM at the encoder's shape (86,835 rows of W = 100 f32
// into 22): bytes, the 34.7 MB of g read once, ~10.4 us at 3.35 TB/s.
// Design, two launches:
//  * relgrad_partial_kernel: one warp a chunk, so a relation's rows spread
//    over ~E / C warps instead of one.  The lanes stride the row's columns,
//    16 bytes a column where W and the pointers allow (rows.cuh), scalars
//    otherwise; the warp reads its chunk's perm entries 32 at a time (a lane
//    each, broadcast by shuffle) and sums the rows g[perm[i]] in sorted
//    order, in fp32 for a float table and fp64 for a double one, with
//    kBatch row loads issued before their adds.  It writes partial[chunk].
//  * relgrad_sum_kernel: one warp an output row r.  It sums the partials of
//    id r - shift in ascending chunk order in fp64 and rounds once; a row
//    with no chunks (or whose id lies outside the layout) writes 0, so no
//    fill launch precedes it.
// No atomics and a fixed order throughout: two runs give the same bits.

#include "rows.cuh"

namespace {

constexpr int kBatch = 8;  // row loads in flight before their adds

// The scalar elements of a column: a float4 / double2 vector or one scalar.
template <typename V>
struct Elems;
template <>
struct Elems<float> {
  using T = float;
  static constexpr int n = 1;
};
template <>
struct Elems<float4> {
  using T = float;
  static constexpr int n = 4;
};
template <>
struct Elems<double> {
  using T = double;
  static constexpr int n = 1;
};
template <>
struct Elems<double2> {
  using T = double;
  static constexpr int n = 2;
};

template <typename V>
__device__ __forceinline__ typename Elems<V>::T& elem(V& v, int i) {
  return reinterpret_cast<typename Elems<V>::T*>(&v)[i];
}
// a scalar column is its own element (no address taken: it stays in a register)
__device__ __forceinline__ float& elem(float& v, int) { return v; }
__device__ __forceinline__ double& elem(double& v, int) { return v; }

template <typename V>
__device__ __forceinline__ V zero() {
  V v;
#pragma unroll
  for (int i = 0; i < Elems<V>::n; ++i) elem(v, i) = 0;
  return v;
}

// a += v, element by element, in the table's own type
template <typename V>
__device__ __forceinline__ void add_to(V& a, V v) {
#pragma unroll
  for (int i = 0; i < Elems<V>::n; ++i) elem(a, i) += elem(v, i);
}

template <typename V>
__global__ void __launch_bounds__(rows::kThreads)
relgrad_partial_kernel(const V* __restrict__ g, const int* __restrict__ perm,
                       const int* __restrict__ chunks, V* __restrict__ partial,
                       int n_chunks, int cols) {
  const int lane = threadIdx.x & 31;
  // the same for the whole warp, so the warp leaves or stays together
  const long long chunk = ((long long)blockIdx.x * rows::kThreads + threadIdx.x) >> 5;
  if (chunk >= n_chunks) return;
  const int lo = chunks[3 * chunk], hi = chunks[3 * chunk + 1];
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < cols;
    V acc = zero<V>();
    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      const int mine = lane < n ? perm[base + lane] : 0;
      int k = 0;
      for (; k + kBatch <= n; k += kBatch) {
        V v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int row = __shfl_sync(0xffffffffu, mine, k + j);
          v[j] = on ? g[(size_t)row * cols + c] : zero<V>();
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) add_to(acc, v[j]);
      }
      for (; k < n; ++k) {
        const int row = __shfl_sync(0xffffffffu, mine, k);
        if (on) add_to(acc, g[(size_t)row * cols + c]);
      }
    }
    if (on) partial[(size_t)chunk * cols + c] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(rows::kThreads)
relgrad_sum_kernel(const V* __restrict__ partial, const int* __restrict__ chunk_ptr,
                   int n_ids, int shift, V* __restrict__ out, int n_rows, int cols) {
  constexpr int N = Elems<V>::n;
  const int lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * rows::kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;
  const long long id = row - shift;
  const bool has = id >= 0 && id < n_ids;
  const int lo = has ? chunk_ptr[id] : 0;
  const int hi = has ? chunk_ptr[id + 1] : 0;
  for (int c = lane; c < cols; c += 32) {
    double acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0;
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      V v = partial[(size_t)k * cols + c];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += (double)elem(v, i);
    }
    V o;
#pragma unroll
    for (int i = 0; i < N; ++i) elem(o, i) = (typename Elems<V>::T)acc[i];
    out[(size_t)row * cols + c] = o;
  }
}

unsigned warp_blocks(long long warps) {
  return (unsigned)((warps * 32 + rows::kThreads - 1) / rows::kThreads);
}

template <typename V>
int launch_both(const void* g, const int* perm, const int* chunks, const int* chunk_ptr,
                void* partial, void* out, int n_chunks, int n_ids, int shift, int n_rows,
                int cols, cudaStream_t stream) {
  if (n_chunks > 0) {
    relgrad_partial_kernel<V><<<warp_blocks(n_chunks), rows::kThreads, 0, stream>>>(
        static_cast<const V*>(g), perm, chunks, static_cast<V*>(partial), n_chunks, cols);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  relgrad_sum_kernel<V><<<warp_blocks(n_rows), rows::kThreads, 0, stream>>>(
      static_cast<const V*>(partial), chunk_ptr, n_ids, shift, static_cast<V*>(out), n_rows,
      cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_relgrad(const T* g, const int* perm, const int* chunks, const int* chunk_ptr,
                   T* partial, T* out, int n_chunks, int n_ids, int shift, int n_rows, int w,
                   cudaStream_t stream) {
  if (n_rows <= 0 || w <= 0) return 0;
  using V = typename rows::Vec<T>::type;
  constexpr int width = rows::Vec<T>::width;
  const bool vec = w % width == 0 && rows::aligned16(g) && rows::aligned16(partial) &&
                   rows::aligned16(out);
  if (vec)
    return launch_both<V>(g, perm, chunks, chunk_ptr, partial, out, n_chunks, n_ids, shift,
                          n_rows, w / width, stream);
  return launch_both<T>(g, perm, chunks, chunk_ptr, partial, out, n_chunks, n_ids, shift,
                        n_rows, w, stream);
}

}  // namespace

// g (E, w) contiguous; perm (E) int32; chunks (n_chunks, 3) int32 (start,
// end, id) over the sorted rows; chunk_ptr (n_ids + 1) int32; partial
// (n_chunks, w) scratch; out (n_rows, w), every row written.
extern "C" int relgrad_f32(const float* g, const int* perm, const int* chunks,
                           const int* chunk_ptr, float* partial, float* out, int n_chunks,
                           int n_ids, int shift, int n_rows, int w, cudaStream_t stream) {
  return launch_relgrad<float>(g, perm, chunks, chunk_ptr, partial, out, n_chunks, n_ids,
                               shift, n_rows, w, stream);
}

extern "C" int relgrad_f64(const double* g, const int* perm, const int* chunks,
                           const int* chunk_ptr, double* partial, double* out, int n_chunks,
                           int n_ids, int shift, int n_rows, int w, cudaStream_t stream) {
  return launch_relgrad<double>(g, perm, chunks, chunk_ptr, partial, out, n_chunks, n_ids,
                                shift, n_rows, w, stream);
}
