// One-pair kernels of the bf16 sweeps' epilogue, one set a family (attrh,
// poincare, lorentz, chyp), compiled only to count SASS instructions a pair
// (scripts/torch_bf16_sweep_bench.py --sass; never launched):
//   <family>_pair_ieee  the pair through score_from_radii<family>
//                       (__fdiv_rn / __fsqrt_rn, the library's log1pf /
//                       logf) or chyp_score(): the epilogue scored in place
//   <family>_pair_fast  the pair through the same steps with FastArith:
//                       one pair of the batched epilogue, its range flag
//                       beside it (chyp: from a2, as the score tile holds
//                       it)
//   <family>_pair_base  the same loads and store with no epilogue, the
//                       overhead to subtract
// Each reads a pair's inputs from `in` (kInputs floats a pair: the query's
// terms, <x, v> and un of both halves, bt, the radius entry; a family
// reads only its own; chyp: acc_re, acc_im, zn, wn, bt, x_min, and a2 in
// place of acc_re for the fast pair) and writes `out`.

#include "../complexhyperbolickge_torch/kernels/csrc/hyp_rank.cu"

namespace {

// c, sqrt_c, x2, c2, c2c2, x2f, c2f, c2c2f, w0, w1, x0 | acc0, acc1, un0,
// un1, bt | the radius entry's 4 floats
constexpr int kInputs = 20;

__device__ __forceinline__ Query probe_query(const float* p) {
  Query q;
  q.c = p[0], q.sqrt_c = p[1], q.x2 = p[2], q.c2 = p[3], q.c2c2 = p[4], q.x2f = p[5];
  q.c2f = p[6], q.c2c2f = p[7], q.w0 = p[8], q.w1 = p[9], q.x0 = p[10], q.t2 = 0.0f;
  return q;
}

// the inputs a family's score reads (pair_base sums exactly these)
template <int kMode>
__device__ __forceinline__ bool reads(int k) {
  if (kMode == kAttRH) return k <= 9 || (k >= 11 && k <= 17);
  if (kMode == kPoincare) return (k >= 1 && k <= 4) || k == 11 || k == 13 || k >= 15;
  return k <= 1 || k == 10 || k == 11 || k == 13 || k == 15 || k == 16 || k == 17;
}

template <int kMode, class Arith>
__device__ __forceinline__ float probe_score(const float* p, Arith& ar) {
  return score_from_radii<kMode>(p[11], p[12], probe_query(p), p[13], p[14], p[15],
                                 make_float4(p[16], p[17], p[18], p[19]), ar);
}

// the FFT family: acc_re (a2 for the fast pair), acc_im, zn, wn, bt, x_min
constexpr int kChypInputs = 6;

template <int kMode>
__device__ __forceinline__ void pair_ieee(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  IeeeArith ar;
  out[i] = probe_score<kMode>(in + kInputs * (size_t)i, ar);
}

template <int kMode>
__device__ __forceinline__ void pair_fast(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FastArith ar;
  out[i] = probe_score<kMode>(in + kInputs * (size_t)i, ar);
  out[n + i] = ar.bad ? 1.0f : 0.0f;
}

template <int kMode>
__device__ __forceinline__ void pair_base(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + kInputs * (size_t)i;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kInputs; ++k)
    if (reads<kMode>(k)) s = __fadd_rn(s, p[k]);
  out[i] = s;
  out[n + i] = 0.0f;
}

__device__ __forceinline__ void chyp_ieee(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + kChypInputs * (size_t)i;
  out[i] = rank_sweeps::chyp_score(p[0], p[1], p[2], p[3], p[4], p[5]);
}

__device__ __forceinline__ void chyp_fast(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + kChypInputs * (size_t)i;
  FastArith ar;
  out[i] = rank_sweeps::chyp_score_a2(p[0], p[2], p[3], p[4], p[5], ar);
  out[n + i] = ar.bad ? 1.0f : 0.0f;
}

__device__ __forceinline__ void chyp_base(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + kChypInputs * (size_t)i;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChypInputs; ++k) s = __fadd_rn(s, p[k]);
  out[i] = s;
  out[n + i] = 0.0f;
}

}  // namespace

#define PAIR_PROBES(family, mode)                                                      \
  extern "C" __global__ void family##_pair_ieee(const float* in, float* out, int n) { \
    pair_ieee<mode>(in, out, n);                                                       \
  }                                                                                    \
  extern "C" __global__ void family##_pair_fast(const float* in, float* out, int n) { \
    pair_fast<mode>(in, out, n);                                                       \
  }                                                                                    \
  extern "C" __global__ void family##_pair_base(const float* in, float* out, int n) { \
    pair_base<mode>(in, out, n);                                                       \
  }

PAIR_PROBES(attrh, kAttRH)
PAIR_PROBES(poincare, kPoincare)
PAIR_PROBES(lorentz, kLorentz)

extern "C" __global__ void chyp_pair_ieee(const float* in, float* out, int n) {
  chyp_ieee(in, out, n);
}
extern "C" __global__ void chyp_pair_fast(const float* in, float* out, int n) {
  chyp_fast(in, out, n);
}
extern "C" __global__ void chyp_pair_base(const float* in, float* out, int n) {
  chyp_base(in, out, n);
}
