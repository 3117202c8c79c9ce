// Train-mode complex-hyperbolic distance, forward and analytic backward,
// hand-written for Hopper (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/chyp_train.py:
//   chyp_train_fwd  <- _fwd_call / _fwd_kernel              (K3)
//   chyp_train_bwd  <- _bwd_call / _bwd_kernel, plus the
//                      d_lhs assembly of _ctd_bwd           (K4)
//
// For query b (lhs row z, D = 2R packed reals [Re | Im]) and candidate k
// (rhs row w of the gathered (B, K, D) block):
//   sr = <z, w> - 1,  si = <swap_neg(z), w>,  swap_neg(z) = [Im | -Re]
//   zn = clip(|z|^2 - 1, -1, -eps),  wn = clip(|w|^2 - 1, -1, -eps)
//   x  = max(2 (sr^2 + si^2) / (zn wn) - 1, 1 + eps),  d = log(x + sqrt(x^2 - 1))
// K3 writes d and the residuals sr, si, wn, x (B, K) and zn (B).  K4 takes
// the cotangent g (B, K) and the residuals and evaluates the reference's
// Distance.backward with each side's denominator clamped,
//   p_z = min(sqrt(x^2 - 1) zn^2 wn, -eps),  p_w = min(sqrt(x^2 - 1) wn^2 zn, -eps)
//   ca_z = 4 g sr zn / p_z,  cb_z = 4 g si zn / p_z,  cz = -4 g a2 / p_z
//   ca_w = 4 g sr wn / p_w,  cb_w = 4 g si wn / p_w,  cw = -4 g a2 / p_w
//   d_rhs[k] = ca_w[k] z + cb_w[k] swap_neg(z) + cw[k] w_k
//   d_lhs    = m_a - swap_neg(m_b) + (sum_k cz[k]) z,
//              m_a = sum_k ca_z[k] w_k,  m_b = sum_k cb_z[k] w_k
// (a2 = sr^2 + si^2).  The dot products over d and the sums over k
// accumulate in fp64 (f32 products are exact there) and round once to f32;
// the plain version does the same, so the two agree to the ulp whatever
// their summation order (an f32 sum of K = 100 terms with cancellation
// differed by 1e-4 relative between two orders).  The f32 arithmetic is
// spelled out in round-to-nearest intrinsics in the order of the JAX
// expressions, so no contraction choice of the compiler moves a result, and
// acosh is log(x + sqrt(x^2 - 1)) as in the TPU kernel and the plain
// version.  Clamps keep NaN as jnp.clip does.
//
// Bound on an H100 SXM at the WN18RR train shape (B = 500, K = 100, D = 66):
// bytes.  K3 reads the 13.2 MB rhs block and writes 5 x 200 KB, ~4.2 us at
// 3.35 TB/s, against 3 D fp64 FMAs and ~20 fp32 operations a pair (~0.6 us
// at 34 TFLOP/s of fp64); K4 reads rhs and writes d_rhs, 26.6 MB, ~8 us.
// Tensor cores cannot help: each dot is one row against K rows, and exact.
// Design (simple and deterministic first): one 256-thread block per query
// row b, with z and swap_neg(z) in shared memory.  K3: each warp takes
// candidates k, its lanes stride over D, warp shuffles reduce the three
// dots, lane 0 writes the epilogue.  K4: the block computes the six (K,)
// coefficients into shared memory, writes d_rhs over (k, d) in one
// coalesced pass, and sums m_a / m_b over k in P = 256 / D fixed groups
// whose fp64 partials are added in group order: no atomics, so K4 gives
// the same bits on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 48 * 1024;  // static launch limit, no opt-in

// Butterfly sum: every lane adds the same two values at every step, so all
// lanes end with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// clip(v, -1, -eps), keeping NaN
__device__ __forceinline__ float clamp_norm(float v, float eps) {
  v = (v < -1.0f) ? -1.0f : v;
  return (v > -eps) ? -eps : v;
}

// swap_neg of a packed row held in shared memory: [Im | -Re]
__device__ __forceinline__ float swapped(const float* v, int i, int R) {
  return (i < R) ? v[i + R] : -v[i - R];
}

__global__ void __launch_bounds__(kThreads)
chyp_train_fwd_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs, float* __restrict__ d_out,
                      float* __restrict__ sr_out, float* __restrict__ si_out,
                      float* __restrict__ wn_out, float* __restrict__ x_out,
                      float* __restrict__ zn_out, int K, int D, float eps,
                      float x_min) {
  extern __shared__ float smem[];
  float* l_s = smem;        // z       [D]
  float* lsw_s = smem + D;  // swap(z) [D]
  __shared__ float zn_s;

  const int b = blockIdx.x;
  const int R = D / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* z = lhs + (size_t)b * D;
  for (int i = threadIdx.x; i < D; i += kThreads) l_s[i] = z[i];
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kThreads) lsw_s[i] = swapped(l_s, i, R);
  if (warp == 0) {
    double acc = 0.0;
    for (int i = lane; i < D; i += 32) {
      const double v = l_s[i];
      acc = __fma_rn(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      zn_s = clamp_norm(__double2float_rn(__dsub_rn(acc, 1.0)), eps);
      zn_out[b] = zn_s;
    }
  }
  __syncthreads();
  const float zn = zn_s;

  for (int k = warp; k < K; k += kWarps) {
    const float* w = rhs + ((size_t)b * K + k) * D;
    double a_re = 0.0, a_im = 0.0, a_ww = 0.0;
    for (int i = lane; i < D; i += 32) {
      const double wi = w[i];
      a_re = __fma_rn((double)l_s[i], wi, a_re);
      a_im = __fma_rn((double)lsw_s[i], wi, a_im);
      a_ww = __fma_rn(wi, wi, a_ww);
    }
    a_re = warp_sum(a_re);
    a_im = warp_sum(a_im);
    a_ww = warp_sum(a_ww);
    if (lane == 0) {
      const size_t o = (size_t)b * K + k;
      const float sr = __double2float_rn(__dsub_rn(a_re, 1.0));
      const float si = __double2float_rn(a_im);
      const float wn = clamp_norm(__double2float_rn(__dsub_rn(a_ww, 1.0)), eps);
      const float a2 = __fadd_rn(__fmul_rn(sr, sr), __fmul_rn(si, si));
      float x = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, a2), __fmul_rn(zn, wn)), 1.0f);
      x = (x < x_min) ? x_min : x;
      d_out[o] = logf(__fadd_rn(x, __fsqrt_rn(__fsub_rn(__fmul_rn(x, x), 1.0f))));
      sr_out[o] = sr;
      si_out[o] = si;
      wn_out[o] = wn;
      x_out[o] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chyp_train_bwd_kernel(const float* __restrict__ g, const float* __restrict__ lhs,
                      const float* __restrict__ rhs, const float* __restrict__ sr,
                      const float* __restrict__ si, const float* __restrict__ wn,
                      const float* __restrict__ x, const float* __restrict__ zn,
                      float* __restrict__ d_lhs, float* __restrict__ d_rhs,
                      int K, int D, int P, float eps) {
  extern __shared__ double smem_d[];
  double* part_a = smem_d;          // [P][D] partial m_a, group-major
  double* part_b = part_a + P * D;  // [P][D] partial m_b
  float* l_s = reinterpret_cast<float*>(part_b + P * D);  // z [D]
  float* lsw_s = l_s + D;           // swap(z) [D]
  float* ca_z = lsw_s + D;          // coefficients, [K] each
  float* cb_z = ca_z + K;
  float* cz = cb_z + K;
  float* ca_w = cz + K;
  float* cb_w = ca_w + K;
  float* cw = cb_w + K;
  float* mb_s = cw + K;             // m_b [D]
  __shared__ float cz_sum;

  const int b = blockIdx.x;
  const int R = D / 2;
  const float zn_b = zn[b];
  const float* z = lhs + (size_t)b * D;
  const float* w = rhs + (size_t)b * K * D;
  for (int i = threadIdx.x; i < D; i += kThreads) l_s[i] = z[i];
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kThreads) lsw_s[i] = swapped(l_s, i, R);

  for (int k = threadIdx.x; k < K; k += kThreads) {
    const size_t o = (size_t)b * K + k;
    const float gk = g[o], s_r = sr[o], s_i = si[o], w_n = wn[o], xk = x[o];
    const float a2 = __fadd_rn(__fmul_rn(s_r, s_r), __fmul_rn(s_i, s_i));
    const float sq = __fsqrt_rn(__fsub_rn(__fmul_rn(xk, xk), 1.0f));
    float p_z = __fmul_rn(__fmul_rn(__fmul_rn(sq, zn_b), zn_b), w_n);
    float p_w = __fmul_rn(__fmul_rn(__fmul_rn(sq, w_n), w_n), zn_b);
    p_z = (p_z > -eps) ? -eps : p_z;  // min(p, -eps), keeping NaN
    p_w = (p_w > -eps) ? -eps : p_w;
    const float g4 = __fmul_rn(gk, 4.0f);
    const float gm4 = __fmul_rn(gk, -4.0f);
    ca_z[k] = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_r), zn_b), p_z);
    cb_z[k] = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_i), zn_b), p_z);
    cz[k] = __fdiv_rn(__fmul_rn(gm4, a2), p_z);
    ca_w[k] = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_r), w_n), p_w);
    cb_w[k] = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_i), w_n), p_w);
    cw[k] = __fdiv_rn(__fmul_rn(gm4, a2), p_w);
  }
  __syncthreads();

  float* dw = d_rhs + (size_t)b * K * D;
  for (int i = threadIdx.x; i < K * D; i += kThreads) {
    const int k = i / D, d = i - k * D;
    dw[i] = __fadd_rn(__fadd_rn(__fmul_rn(ca_w[k], l_s[d]),
                                __fmul_rn(cb_w[k], lsw_s[d])),
                      __fmul_rn(cw[k], w[i]));
  }
  // m_a, m_b: group p sums k = p, p + P, ... in ascending order
  for (int i = threadIdx.x; i < P * D; i += kThreads) {
    const int p = i / D, d = i - p * D;
    double ma = 0.0, mb = 0.0;
    for (int k = p; k < K; k += P) {
      const double wk = w[(size_t)k * D + d];
      ma = __fma_rn((double)ca_z[k], wk, ma);
      mb = __fma_rn((double)cb_z[k], wk, mb);
    }
    part_a[i] = ma;
    part_b[i] = mb;
  }
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int k = 0; k < K; ++k) s = __dadd_rn(s, (double)cz[k]);
    cz_sum = __double2float_rn(s);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    double mb = part_b[d];
    for (int p = 1; p < P; ++p) mb = __dadd_rn(mb, part_b[p * D + d]);
    mb_s[d] = __double2float_rn(mb);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    double ma = part_a[d];
    for (int p = 1; p < P; ++p) ma = __dadd_rn(ma, part_a[p * D + d]);
    d_lhs[(size_t)b * D + d] =
        __fadd_rn(__fsub_rn(__double2float_rn(ma), swapped(mb_s, d, R)),
                  __fmul_rn(cz_sum, l_s[d]));
  }
}

}  // namespace

// C interface, loaded with ctypes.  Each launcher enqueues on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape whose shared memory exceeds 48 KB.
// D must be even (packed [Re | Im]); every array is contiguous float32.
extern "C" int chyp_train_fwd(const float* lhs, const float* rhs, float* d,
                              float* sr, float* si, float* wn, float* x,
                              float* zn, int B, int K, int D, float eps,
                              float x_min, cudaStream_t stream) {
  if (B <= 0) return 0;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  chyp_train_fwd_kernel<<<B, kThreads, smem, stream>>>(lhs, rhs, d, sr, si, wn,
                                                       x, zn, K, D, eps, x_min);
  return (int)cudaGetLastError();
}

extern "C" int chyp_train_bwd(const float* g, const float* lhs,
                              const float* rhs, const float* sr,
                              const float* si, const float* wn, const float* x,
                              const float* zn, float* d_lhs, float* d_rhs,
                              int B, int K, int D, float eps,
                              cudaStream_t stream) {
  if (B <= 0) return 0;
  const int P = (D > 0 && D < kThreads) ? kThreads / D : 1;
  const size_t smem = 2 * (size_t)P * D * sizeof(double) +
                      (3 * (size_t)D + 6 * (size_t)K) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  chyp_train_bwd_kernel<<<B, kThreads, smem, stream>>>(
      g, lhs, rhs, sr, si, wn, x, zn, d_lhs, d_rhs, K, D, P, eps);
  return (int)cudaGetLastError();
}
