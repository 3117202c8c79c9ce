// Row gather (K10), hand-written for Hopper (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/gather.py:pallas_row_gather
// (its pallas_call, _gather_kernel):  out[i, :] = x[ids[i], :].
// The TPU kernel issues one DMA per row and pads every row to a 4 KB DMA
// unit (Mosaic's floor), returns (E, round_up(H, 1024)) with zero pad
// columns and needs E % chunk == 0.  None of that holds here: the output is
// exactly (E, H) and E is any size.  It is the GNN encoder's edge gather
// x[tail] (and, with ids = dst, the backward of the sorted segment sum K9).
//
// Bound on an H100 SXM at the encoder's shape (one half, E = 86,835 rows of
// H = 200 f32, 800 B each, from a 40,943-row table): bytes.  It must read
// the distinct rows its ids fetch once (uniform tails hit ~36.0k of the
// 40,943, 28.8 MB) and write 69.5 MB, ~29.4 us at 3.35 TB/s (~4.8 us at
// H = 32); fetching every edge's row from HBM would move 139 MB, ~41.6 us,
// but the table fits in the 50 MB L2, so repeated rows come from there.
// Design (rows.cuh): one warp per output row, or several rows per warp when
// a row has fewer than 32 vector columns; the lanes of a row stride its
// columns with 16-byte loads and stores where H and the pointers allow.  A
// copy: the output is bitwise x[ids].  ids must lie in [0, N): the callers
// build them once from a static graph and check them there.

#include "rows.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(rows::kThreads)
row_gather_kernel(const V* __restrict__ x, const int* __restrict__ ids,
                  V* __restrict__ out, int n_out, int cols, int lanes, int rpw) {
  long long row;
  int c;
  if (!rows::thread_row(n_out, lanes, rpw, &row, &c)) return;
  const V* src = x + (size_t)ids[row] * cols;
  V* dst = out + (size_t)row * cols;
  for (; c < cols; c += lanes) dst[c] = src[c];
}

template <typename T>
int launch_gather(const T* x, const int* ids, T* out, int n_out, int h,
                  cudaStream_t stream) {
  if (n_out <= 0 || h <= 0) return 0;
  using V = typename rows::Vec<T>::type;
  const rows::Geometry g = rows::geometry<T>(n_out, h, x, out);
  if (g.vec)
    row_gather_kernel<V><<<g.blocks, rows::kThreads, 0, stream>>>(
        reinterpret_cast<const V*>(x), ids, reinterpret_cast<V*>(out), n_out,
        g.cols, g.lanes, g.rpw);
  else
    row_gather_kernel<T><<<g.blocks, rows::kThreads, 0, stream>>>(
        x, ids, out, n_out, g.cols, g.lanes, g.rpw);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H) contiguous, ids (n_out) int32 in [0, N), out (n_out, H) contiguous.
extern "C" int row_gather_f32(const float* x, const int* ids, float* out,
                              int n_out, int h, cudaStream_t stream) {
  return launch_gather<float>(x, ids, out, n_out, h, stream);
}

extern "C" int row_gather_f64(const double* x, const int* ids, double* out,
                              int n_out, int h, cudaStream_t stream) {
  return launch_gather<double>(x, ids, out, n_out, h, stream);
}

// bf16 rows are copied as bits: 8 to a 16-byte vector where H % 8 == 0.
extern "C" int row_gather_bf16(const __nv_bfloat16* x, const int* ids,
                               __nv_bfloat16* out, int n_out, int h,
                               cudaStream_t stream) {
  return launch_gather<__nv_bfloat16>(x, ids, out, n_out, h, stream);
}
