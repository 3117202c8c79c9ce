// Sorted segment sum (K9), hand-written for Hopper (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/segsum.py:make_sorted_segment_sum
// (its pallas_call, _sorted_segment_sum_fwd / _segsum_kernel):
//   out[n, :] = sum_{e : dst[e] = n} msgs[e, :]
// over edges sorted by their destination, the GNN encoder's aggregation
// into the N nodes.  The TPU kernel turns the scatter into one-hot (Tn, Te)
// @ (Te, H) matrix products per node tile, because a TPU scatters rows far
// from its stream rate.  Here it is a CSR segmented reduction: row_ptr
// (N + 1 int32, built once on the host from the static sorted dst) gives
// node n its contiguous edge range [row_ptr[n], row_ptr[n + 1]).
//
// Bound on an H100 SXM at the encoder's shape (one sorted half, E = 86,835
// edges into N = 40,943 nodes): bytes.  At H = 200 f32 it reads the 69.5 MB
// of messages once and writes the 32.8 MB output, ~30.6 us at 3.35 TB/s
// (~4.9 us at H = 32); one add per message element is nothing beside that.
// Design (rows.cuh): one warp per destination row, or several rows per warp
// when a row has fewer than 32 vector columns (H = 32 f32: 8 float4
// columns, 4 rows a warp; H = 1: 32 rows a warp).  The lanes of a row
// stride its columns with 16-byte loads where H and both pointers allow, so
// a warp reads contiguous row segments; each lane sums its columns over the
// row's edges in edge order, in fp32 (fp64 for the double instance).  No
// atomics and no cross-thread reduction, so the result is deterministic,
// and a row without edges writes 0.  The backward, d_msgs = d_out[dst], is
// a launch of the row gather (K10, gather.cu).

#include "rows.cuh"

namespace {

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ double vzero(double) { return 0.0; }
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ double2 vzero(double2) {
  return make_double2(0.0, 0.0);
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

template <typename V>
__global__ void __launch_bounds__(rows::kThreads)
segsum_kernel(const V* __restrict__ msgs, const int* __restrict__ row_ptr,
              V* __restrict__ out, int n_rows, int cols, int lanes, int rpw) {
  long long row;
  int c;
  if (!rows::thread_row(n_rows, lanes, rpw, &row, &c)) return;
  const int lo = row_ptr[row];
  const int hi = row_ptr[row + 1];
  for (; c < cols; c += lanes) {
    V acc = vzero(V());
    for (int e = lo; e < hi; ++e) acc = vadd(acc, msgs[(size_t)e * cols + c]);
    out[(size_t)row * cols + c] = acc;
  }
}

template <typename T>
int launch_segsum(const T* msgs, const int* row_ptr, T* out, int n_rows,
                  int h, cudaStream_t stream) {
  if (n_rows <= 0 || h <= 0) return 0;
  using V = typename rows::Vec<T>::type;
  const rows::Geometry g = rows::geometry<T>(n_rows, h, msgs, out);
  if (g.vec)
    segsum_kernel<V><<<g.blocks, rows::kThreads, 0, stream>>>(
        reinterpret_cast<const V*>(msgs), row_ptr, reinterpret_cast<V*>(out),
        n_rows, g.cols, g.lanes, g.rpw);
  else
    segsum_kernel<T><<<g.blocks, rows::kThreads, 0, stream>>>(
        msgs, row_ptr, out, n_rows, g.cols, g.lanes, g.rpw);
  return (int)cudaGetLastError();
}

}  // namespace

// msgs (E, H) contiguous, row_ptr (n_rows + 1) int32 with row_ptr[0] = 0 and
// row_ptr[n_rows] = E, out (n_rows, H) contiguous.
extern "C" int segsum_f32(const float* msgs, const int* row_ptr, float* out,
                          int n_rows, int h, cudaStream_t stream) {
  return launch_segsum<float>(msgs, row_ptr, out, n_rows, h, stream);
}

extern "C" int segsum_f64(const double* msgs, const int* row_ptr, double* out,
                          int n_rows, int h, cudaStream_t stream) {
  return launch_segsum<double>(msgs, row_ptr, out, n_rows, h, stream);
}
