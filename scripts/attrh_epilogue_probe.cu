// One-pair kernels of the AttRH bf16 sweep's epilogue, compiled only to
// count SASS instructions a pair (scripts/torch_attrh_bf16_bench.py
// --sass; never launched):
//   attrh_pair_ieee  the pair through score_from_radii<kAttRH>
//                    (__fdiv_rn / __fsqrt_rn): the epilogue scored in place
//   attrh_pair_fast  the pair through attrh_score with FastArith: one pair
//                    of the batched epilogue, its range flag beside it
//   attrh_pair_base  the same loads and store with no epilogue, the
//                    overhead to subtract
// Each reads a pair's 17 inputs (the query's terms, <x, v> of both halves,
// un of both halves, bt, the radius entry) from `in` and writes `out`.

#include "../complexhyperbolickge_torch/kernels/csrc/hyp_rank.cu"

namespace {

__device__ __forceinline__ Query probe_query(const float* p) {
  Query q;
  q.c = p[0], q.sqrt_c = p[1], q.x2 = p[2], q.c2 = p[3], q.c2c2 = p[4], q.x2f = p[5];
  q.c2f = p[6], q.c2c2f = p[7], q.w0 = p[8], q.w1 = p[9], q.t2 = 0.0f, q.x0 = 0.0f;
  return q;
}

}  // namespace

extern "C" __global__ void attrh_pair_ieee(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + 17 * (size_t)i;
  out[i] = score_from_radii<kAttRH>(p[10], p[11], probe_query(p), p[12], p[13], p[14],
                                    make_float4(p[15], p[16], 0.0f, 0.0f));
}

extern "C" __global__ void attrh_pair_fast(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + 17 * (size_t)i;
  FastArith ar;
  out[i] = attrh_score(p[10], p[11], probe_query(p), p[12], p[13], p[14], p[15], p[16], ar);
  out[n + i] = ar.bad ? 1.0f : 0.0f;
}

extern "C" __global__ void attrh_pair_base(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = in + 17 * (size_t)i;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 17; ++k) s = __fadd_rn(s, p[k]);
  out[i] = s;
  out[n + i] = 0.0f;
}
