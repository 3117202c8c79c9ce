// RotH's ranker query prep, hand-written for Hopper (sm_90a): what
// kernels/hyp_rank.py HypRanker._queries_core computes for a RotH model
// (models/hyperbolic.py RotH.get_queries, then BaseH.sim of the gold tail in
// its broadcast form and the threshold), in one launch.
//
// Row b of the queries (h, r, g) = q[b qs + 0, 1, 2] computes, with D <= 64
// real coordinates, cid = r (multi_c) or 0, c = cvals[cid], s = sqrt(c):
//   hh  = expmap0(entity[h], c);  r1 = expmap0(rel[r][:D], c);  r2 = expmap0(rel[r][D:], c)
//   l   = project(mobius_add(hh, r1, c), c)
//   lhs = mobius_add(givens(rel_diag[r], l), r2, c)
//   v   = expmap0(entity[g], c)               (BaseH.sim's expmap0 of the tail)
//   d   = hyp_distance_multi_c(lhs, v, c)     (which folds v's radius once more)
//   t2  = -d^2, plus bt[g] under bias learn
// and writes lhs (B, D), x2 = |lhs|^2, cid (int32), c and t2 (B each).
// expmap0 includes its project.  project's margin is the float32 ball's
// 1 - ball_eps, passed in as one f32 value (the plain version rounds the
// same double); the clamps are ops/math.py's: tanh's input to +-15, artanh's
// to +-(1 - 1e-5), MIN_NORM under the distance's square root and
// denominator and MIN_NORM^2 under each norm.
//
// Design.  One warp a row, the lane's coordinate pair of each vector in
// registers (chyp_chain.cuh: exp0, project, mobius_add, givens, and the fp64
// warp sums of every norm and dot); the chain's scalars are f32 on every
// lane in the order of the PyTorch expressions, each sum rounded once.  The
// threshold's distance is ill-conditioned near the ball's edge (1 - c |x|^2
// and artanh's argument cancel), so it runs in fp64 from the unrounded sums
// (<lhs, v / |v|> as <lhs, v> over |v|), adds bt[g] in fp64 and rounds t2
// once.  Lane 0 writes the scalars.  No shared memory, no atomics.  A row
// whose h, r or g lies outside its table gets NaN outputs and cid -1, so the
// sweep counts it 0 and its rank is NaN.

#include <cuda_runtime.h>

#include <cstdint>

#include "chyp_chain.cuh"

namespace {

using chain::Pair;

constexpr int kWarps = 4;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr double kArtanhMax = 1.0 - 1e-5;  // artanh's input clamp
constexpr double kMinNorm = 1e-15;         // the distance's floors (MIN_NORM)
constexpr double kMinNorm2 = 1e-30;        // the norm's (MIN_NORM^2)

struct Tables {
  const float* entity;    // (N, D)
  const float* rel;       // (nR, 2 D)
  const float* rel_diag;  // (nR, D)
  const float* bt;        // (N, 1), read under bias learn
  const float* cvals;     // (n_c,)
};

struct Shape {
  const int64_t* q;  // (B, .) int64, h, r and g in columns 0, 1 and 2
  long long qs;      // q's row stride
  int B, N, nR, D, multi_c, learn;
  float margin;      // project's 1 - ball_eps
};

__device__ __forceinline__ Pair load_pair(const float* p, bool mine) {
  return mine ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ double dclamp(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);  // keeps NaN, as torch.clamp
}

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dquo(double a, double b) { return __ddiv_rn(a, b); }

// expmap0 with its project (ops/hyperbolic.py)
__device__ __forceinline__ Pair expmap0(Pair u, float s, float rs, float margin) {
  chain::Exp0 e;
  chain::Proj p;
  return chain::project(chain::exp0(u, s, e), rs, p, margin);
}

// -d^2 of ops/hyperbolic.py::_hyp_dist_multi_c_from_parts in fp64, at x2 =
// |x|^2, xv = <x, v / |v|>, the radius vn = |v| and s = sqrt(c): gamma =
// tanh(s vn) / s, one rounding an operation in the order of its expressions.
__device__ __forceinline__ double neg_sq_dist(double x2, double xv, double vn, double c,
                                              double s) {
  const double tmax = chain::kTanhMax;
  const double gamma = dquo(tanh(dclamp(dmul(s, vn), -tmax, tmax)), s);
  const double g2 = dmul(gamma, gamma);
  const double one_t = dsub(1.0, dmul(dmul(dmul(2.0, c), gamma), xv));  // 1 - 2 c gamma xv
  const double c1 = dadd(one_t, dmul(c, g2));
  const double c2 = dsub(1.0, dmul(c, x2));
  const double sq = dsub(dadd(dmul(dmul(c1, c1), x2), dmul(dmul(c2, c2), g2)),
                         dmul(dmul(dmul(dmul(2.0, c1), c2), gamma), xv));
  const double num = __dsqrt_rn(sq < kMinNorm ? kMinNorm : sq);
  const double den = dadd(one_t, dmul(dmul(dmul(c, c), g2), x2));
  const double z = dclamp(dmul(s, dquo(num, den < kMinNorm ? kMinNorm : den)), -kArtanhMax,
                          kArtanhMax);
  const double d = dquo(dmul(2.0, dmul(0.5, dsub(log1p(z), log1p(-z)))), s);
  return -dmul(d, d);
}

__global__ void __launch_bounds__(kThreads)
roth_rank_queries_kernel(Tables t, Shape sh, float* __restrict__ lhs, float* __restrict__ x2o,
                         int* __restrict__ cido, float* __restrict__ co,
                         float* __restrict__ t2o) {
  using chain::Giv, chain::Mob, chain::Proj, chain::dot, chain::rnd;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= sh.B) return;  // the whole warp
  const int D = sh.D;
  const bool mine = 2 * lane < D;
  const int64_t* qb = sh.q + (long long)b * sh.qs;
  const long long h = qb[0], r = qb[1], g = qb[2];
  float* out = lhs + (size_t)b * D;
  if (h < 0 || h >= sh.N || r < 0 || r >= sh.nR || g < 0 || g >= sh.N) {
    const float nan = __int_as_float(0x7fffffff);
    for (int j = lane; j < D; j += 32) out[j] = nan;
    if (lane == 0) {
      x2o[b] = co[b] = t2o[b] = nan;
      cido[b] = -1;
    }
    return;
  }
  const int cid = sh.multi_c ? (int)r : 0;
  const float c = t.cvals[cid];
  const float s = __fsqrt_rn(c);
  const float rs = __frcp_rn(s);
  const float* rel = t.rel + (size_t)r * 2 * D;
  const Pair hh = expmap0(load_pair(t.entity + (size_t)h * D + 2 * lane, mine), s, rs,
                          sh.margin);
  const Pair r1 = expmap0(load_pair(rel + 2 * lane, mine), s, rs, sh.margin);
  const Pair r2 = expmap0(load_pair(rel + D + 2 * lane, mine), s, rs, sh.margin);
  Mob m1, m2;
  Proj pl;
  Giv gv;
  const Pair l = chain::project(chain::mobius_add(hh, r1, c, m1), rs, pl, sh.margin);
  const Pair gq = chain::givens(load_pair(t.rel_diag + (size_t)r * D + 2 * lane, mine), l, gv);
  const Pair x = chain::mobius_add(gq, r2, c, m2);
  const Pair v = expmap0(load_pair(t.entity + (size_t)g * D + 2 * lane, mine), s, rs,
                         sh.margin);
  double vv = dot(v, v), xv = dot(x, v), xx = dot(x, x);
  chain::warp_sum3(vv, xv, xx);
  const double vn = __dsqrt_rn(vv < kMinNorm2 ? kMinNorm2 : vv);
  double nd = neg_sq_dist(xx, dquo(xv, vn), vn, c, __dsqrt_rn(c));
  if (sh.learn) nd = dadd(nd, t.bt[g]);
  const float t2 = rnd(nd);
  if (mine) *reinterpret_cast<float2*>(out + 2 * lane) = x;
  if (lane == 0) {
    x2o[b] = rnd(xx);
    cido[b] = cid;
    co[b] = c;
    t2o[b] = t2;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Enqueues on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take (B, N, nR < 1; D odd,
// below 2 or above 64; n_c other than nR with multi_c or 1 without).
// Tables are contiguous float32 (entity (N, D), rel (nR, 2 D), rel_diag
// (nR, D), bt (N), cvals (n_c)), 8-byte aligned; q (B, >= 3) int64 rows qs
// apart; the outputs lhs (B, D), x2, c, t2 float32 and cid int32 (B each).
extern "C" int roth_rank_queries(const float* entity, const float* rel, const float* rel_diag,
                                 const float* bt, const float* cvals, const int64_t* q, int qs,
                                 float* lhs, float* x2, int* cid, float* c, float* t2, int B,
                                 int N, int nR, int n_c, int D, int multi_c, int learn,
                                 float margin, cudaStream_t stream) {
  if (B < 1 || N < 1 || nR < 1 || D < 2 || D % 2 || D > chain::kMaxN ||
      n_c != (multi_c ? nR : 1))
    return (int)cudaErrorInvalidValue;
  const Tables t{entity, rel, rel_diag, bt, cvals};
  const Shape sh{q, (long long)qs, B, N, nR, D, multi_c, learn, margin};
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  roth_rank_queries_kernel<<<grid, kThreads, 0, stream>>>(t, sh, lhs, x2, cid, c, t2);
  return (int)cudaGetLastError();
}
