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
// row's edges in edge order, in fp32 (fp64 for the double instance; the
// bf16 instance loads bf16, 8 to a 16-byte vector, sums in fp32 and rounds
// once to bf16 on store, half the bytes of f32).  No atomics and no
// cross-thread reduction, so the result is deterministic, and a row
// without edges writes 0.  The backward, d_msgs = d_out[dst], is a launch
// of the row gather (K10, gather.cu).

#include "rows.cuh"

namespace {

// How one column of a row is summed: Acc, the running sum, from a zero,
// plus each message element, and the stored value.  f32 and f64 (scalars
// and 16-byte vectors) sum in their own type; bf16 sums in fp32 and rounds
// once, round to nearest even.
template <typename V>
struct Sum;

template <>
struct Sum<float> {
  using Acc = float;
  static __device__ __forceinline__ Acc zero() { return 0.0f; }
  static __device__ __forceinline__ Acc add(Acc a, float v) { return a + v; }
  static __device__ __forceinline__ float store(Acc a) { return a; }
};

template <>
struct Sum<double> {
  using Acc = double;
  static __device__ __forceinline__ Acc zero() { return 0.0; }
  static __device__ __forceinline__ Acc add(Acc a, double v) { return a + v; }
  static __device__ __forceinline__ double store(Acc a) { return a; }
};

template <>
struct Sum<float4> {
  using Acc = float4;
  static __device__ __forceinline__ Acc zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ __forceinline__ Acc add(Acc a, float4 v) {
    return make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
  }
  static __device__ __forceinline__ float4 store(Acc a) { return a; }
};

template <>
struct Sum<double2> {
  using Acc = double2;
  static __device__ __forceinline__ Acc zero() { return make_double2(0.0, 0.0); }
  static __device__ __forceinline__ Acc add(Acc a, double2 v) {
    return make_double2(a.x + v.x, a.y + v.y);
  }
  static __device__ __forceinline__ double2 store(Acc a) { return a; }
};

// a bf16 is the top half of the float it widens to: exact
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <>
struct Sum<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ Acc zero() { return 0.0f; }
  static __device__ __forceinline__ Acc add(Acc a, __nv_bfloat16 v) {
    return a + __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(Acc a) { return __float2bfloat16_rn(a); }
};

template <>
struct Sum<uint4> {  // 8 bf16
  struct Acc {
    float v[8];
  };
  static __device__ __forceinline__ Acc zero() {
    Acc a;
#pragma unroll
    for (int i = 0; i < 8; ++i) a.v[i] = 0.0f;
    return a;
  }
  static __device__ __forceinline__ Acc add(Acc a, uint4 v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.v[2 * i] += bf16_lo(w[i]);
      a.v[2 * i + 1] += bf16_hi(w[i]);
    }
    return a;
  }
  static __device__ __forceinline__ uint4 store(Acc a) {
    return make_uint4(bf16_pack(a.v[0], a.v[1]), bf16_pack(a.v[2], a.v[3]),
                      bf16_pack(a.v[4], a.v[5]), bf16_pack(a.v[6], a.v[7]));
  }
};

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
    typename Sum<V>::Acc acc = Sum<V>::zero();
    for (int e = lo; e < hi; ++e) acc = Sum<V>::add(acc, msgs[(size_t)e * cols + c]);
    out[(size_t)row * cols + c] = Sum<V>::store(acc);
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

extern "C" int segsum_bf16(const __nv_bfloat16* msgs, const int* row_ptr,
                           __nv_bfloat16* out, int n_rows, int h,
                           cudaStream_t stream) {
  return launch_segsum<__nv_bfloat16>(msgs, row_ptr, out, n_rows, h, stream);
}
