// The pieces of the FFT models' query chains (models/chyperbolic.py) and of
// the Poincare ball's (models/hyperbolic.py), one warp a query row, and
// their backward steps: the packed DFTs as products
// with the matrices of ops/fft.py, expmap0, project, real_mobius_add
// (ops/chyperbolic.py) and the Givens rotation (ops/euclidean.py).
//
// A row's real vectors have n <= 64 coordinates; lane l holds the pair
// (2 l, 2 l + 1) as a float2 (zeros past n), so a Givens pair never
// crosses lanes.  The sums over a vector (norms and dots) accumulate the
// exact fp64 products of the f32 values and reduce by an xor butterfly
// (every lane ends with the same bits) before one rounding to f32; the
// DFTs sum fp64 products with the fp64 matrix in row order and round once.
// Every other operation is f32 and spelled out in round-to-nearest
// intrinsics, one rounding an operation in the order of the PyTorch
// expressions, so no FMA contraction moves a result.  Clamps keep NaN as
// torch.clamp does; a backward step passes a clamp's gradient where
// lo <= v <= hi and takes torch.where's branch, as autograd does.

#pragma once

#include <cuda_runtime.h>

namespace chain {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;                  // real coordinates a row: one pair a lane
constexpr float kMinNorm = 1e-15f;         // ops/math.py MIN_NORM: mobius_add's denominator
constexpr float kMinNorm2 = 1e-30f;        // MIN_NORM^2: safe_norm's clamp
constexpr float kTanhMax = 15.0f;          // ops/math.py tanh's input clamp
constexpr float kMargin = 0.99999f;        // project's 1 - 1e-5
constexpr float kTiny = 1.17549435e-38f;   // float32 tiny: _unit_pairs' clamp

using Pair = float2;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rnd(double v) { return __double2float_rn(v); }

// max(v, lo), keeping NaN; and the gradient g where lo <= v, else 0
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float pass_min(float g, float v, float lo) { return v >= lo ? g : 0.0f; }

// the lane's part of a dot product: exact fp64 products
__device__ __forceinline__ double dot(Pair x, Pair y) {
  return __fma_rn((double)x.x, (double)y.x, (double)x.y * (double)y.y);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double pa = __shfl_xor_sync(kFull, a, o), pb = __shfl_xor_sync(kFull, b, o);
    a = __dadd_rn(a, pa);
    b = __dadd_rn(b, pb);
  }
}

__device__ __forceinline__ void warp_sum3(double& a, double& b, double& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double pa = __shfl_xor_sync(kFull, a, o), pb = __shfl_xor_sync(kFull, b, o);
    const double pc = __shfl_xor_sync(kFull, c, o);
    a = __dadd_rn(a, pa);
    b = __dadd_rn(b, pb);
    c = __dadd_rn(c, pc);
  }
}

// ------------------------------- packed DFT ----------------------------------

// The lane's pair of v M: v (k values, fp64, shared), M (k x n row-major,
// fp64, shared, 16-byte aligned); fp64 sums in row order, rounded once.
__device__ __forceinline__ Pair times_pair(const double* v, const double* M, int k, int n,
                                           int lane) {
  double a0 = 0.0, a1 = 0.0;
  const int i = 2 * lane;
  if (i < n) {
    for (int j = 0; j < k; ++j) {
      const double2 m = *reinterpret_cast<const double2*>(M + j * n + i);
      a0 = __fma_rn(v[j], m.x, a0);
      a1 = __fma_rn(v[j], m.y, a1);
    }
  }
  return make_float2(rnd(a0), rnd(a1));
}

// out[j] = (v M)[j] for j = lane, lane + 32, ... < m: v (k values), M (k x
// m row-major), both fp64 in shared memory; fp64 sums in row order.
__device__ __forceinline__ void times_to(const double* v, const double* M, int k, int m,
                                         int lane, float* __restrict__ out) {
  for (int j = lane; j < m; j += 32) {
    double a = 0.0;
    for (int i = 0; i < k; ++i) a = __fma_rn(v[i], M[i * m + j], a);
    out[j] = rnd(a);
  }
}

// The warp's pairs as an fp64 vector in shared memory (n values).
__device__ __forceinline__ void put_pair(double* v, Pair x, int n, int lane) {
  if (2 * lane < n) {
    v[2 * lane] = x.x;
    v[2 * lane + 1] = x.y;
  }
}

// ------------------------------ forward steps --------------------------------

// expmap0 before its project: gamma = tanh(clamp(a, -15, 15)) u / a,
// a = s n, n = sqrt(max(|u|^2, MIN_NORM^2)), s = sqrt(c).
struct Exp0 {
  float sq, nu, a, t;
};

__device__ __forceinline__ Pair exp0(Pair u, float s, Exp0& e) {
  e.sq = rnd(warp_sum(dot(u, u)));
  e.nu = __fsqrt_rn(clamp_min(e.sq, kMinNorm2));
  e.a = mul(s, e.nu);
  const float ac = e.a < -kTanhMax ? -kTanhMax : (e.a > kTanhMax ? kTanhMax : e.a);
  e.t = tanhf(ac);
  return make_float2(quo(mul(e.t, u.x), e.a), quo(mul(e.t, u.y), e.a));
}

// project: x / n * mx where n = sqrt(max(|x|^2, MIN_NORM^2)) > mx =
// (1 / s) * margin, else x (rs = 1 / s).  The FFT chains' margin is
// 1 - 1e-5; the Poincare ball's in float32 is 1 - ball_eps (0.996), which
// its callers pass.
struct Proj {
  float sx, nx, mx;
  bool on;
};

__device__ __forceinline__ Pair project(Pair x, float rs, Proj& p, float margin = kMargin) {
  p.sx = rnd(warp_sum(dot(x, x)));
  p.nx = __fsqrt_rn(clamp_min(p.sx, kMinNorm2));
  p.mx = mul(rs, margin);
  p.on = p.nx > p.mx;
  if (!p.on) return x;
  return make_float2(mul(quo(x.x, p.nx), p.mx), mul(quo(x.y, p.nx), p.mx));
}

// real_mobius_add: ((1 + 2 c xy + c y2) x + (1 - c x2) y) / max(den, MIN_NORM),
// den = 1 + 2 c xy + c^2 x2 y2.
struct Mob {
  float x2, y2, xy, A, Bc, den, denc;
};

__device__ __forceinline__ Pair mob_num(Pair x, Pair y, const Mob& m) {
  return make_float2(add(mul(m.A, x.x), mul(m.Bc, y.x)), add(mul(m.A, x.y), mul(m.Bc, y.y)));
}

__device__ __forceinline__ Pair mobius_add(Pair x, Pair y, float c, Mob& m) {
  double x2 = dot(x, x), y2 = dot(y, y), xy = dot(x, y);
  warp_sum3(x2, y2, xy);
  m.x2 = rnd(x2);
  m.y2 = rnd(y2);
  m.xy = rnd(xy);
  const float one_t1 = add(1.0f, mul(mul(2.0f, c), m.xy));
  m.A = add(one_t1, mul(c, m.y2));
  m.Bc = sub(1.0f, mul(c, m.x2));
  m.den = add(one_t1, mul(mul(mul(c, c), m.x2), m.y2));
  m.denc = clamp_min(m.den, kMinNorm);
  const Pair num = mob_num(x, y, m);
  return make_float2(quo(num.x, m.denc), quo(num.y, m.denc));
}

// Givens rotation of the pair x by (cos, sin) = g / sqrt(max(|g|^2, tiny)).
struct Giv {
  float q, nq, cs, sn;
};

__device__ __forceinline__ Pair givens(Pair g, Pair x, Giv& v) {
  v.q = add(mul(g.x, g.x), mul(g.y, g.y));
  v.nq = __fsqrt_rn(clamp_min(v.q, kTiny));
  v.cs = quo(g.x, v.nq);
  v.sn = quo(g.y, v.nq);
  return make_float2(sub(mul(v.cs, x.x), mul(v.sn, x.y)), add(mul(v.sn, x.x), mul(v.cs, x.y)));
}

// ------------------------------ backward steps -------------------------------

// expmap0 (before project) at u with output gam: the gradient of u for
// gg; adds the gradient of s to gs.
__device__ __forceinline__ Pair exp0_vjp(Pair u, Pair gam, float s, const Exp0& e, Pair gg,
                                         float& gs) {
  const Pair gtu = make_float2(quo(gg.x, e.a), quo(gg.y, e.a));  // of t u
  double gt = dot(gtu, u), ga = dot(gtu, gam);
  warp_sum2(gt, ga);
  const float g_ac = mul(rnd(gt), sub(1.0f, mul(e.t, e.t)));
  const bool inside = e.a >= -kTanhMax && e.a <= kTanhMax;
  const float g_a = add(-rnd(ga), inside ? g_ac : 0.0f);
  gs = add(gs, mul(g_a, e.nu));
  const float g_sq = pass_min(quo(mul(g_a, s), mul(2.0f, e.nu)), e.sq, kMinNorm2);
  return make_float2(add(mul(gtu.x, e.t), mul(mul(2.0f, u.x), g_sq)),
                     add(mul(gtu.y, e.t), mul(mul(2.0f, u.y), g_sq)));
}

// project at x: the gradient of x for go; adds the gradient of rs = 1 / s
// to grs.
__device__ __forceinline__ Pair project_vjp(Pair x, const Proj& p, Pair go, float& grs) {
  if (!p.on) return go;  // the same branch on every lane: p is the warp's
  const Pair q = make_float2(quo(x.x, p.nx), quo(x.y, p.nx));
  const float g_mx = rnd(warp_sum(dot(go, q)));
  const float g_nx = quo(-mul(g_mx, p.mx), p.nx);
  const float g_sx = pass_min(quo(g_nx, mul(2.0f, p.nx)), p.sx, kMinNorm2);
  grs = add(grs, mul(g_mx, kMargin));
  return make_float2(add(quo(mul(go.x, p.mx), p.nx), mul(mul(2.0f, x.x), g_sx)),
                     add(quo(mul(go.y, p.mx), p.nx), mul(mul(2.0f, x.y), g_sx)));
}

// real_mobius_add at (x, y): the gradients of x and y for go; adds the
// gradient of c to gc.
__device__ __forceinline__ void mobius_add_vjp(Pair x, Pair y, float c, const Mob& m, Pair go,
                                               Pair& gx, Pair& gy, float& gc) {
  const Pair num = mob_num(x, y, m);
  const Pair gn = make_float2(quo(go.x, m.denc), quo(go.y, m.denc));
  double s = dot(go, num), sa = dot(gn, x), sb = dot(gn, y);
  warp_sum3(s, sa, sb);
  const float g_A = rnd(sa), g_B = rnd(sb);
  const float g_den = pass_min(quo(-rnd(s), mul(m.denc, m.denc)), m.den, kMinNorm);
  const float g_t1 = add(g_A, g_den);        // t1 = 2 c xy, in A and den
  const float g_xy = mul(mul(2.0f, c), g_t1);
  const float g_w = mul(m.y2, g_den);        // w = c^2 x2, den's w y2
  const float g_y2 = add(mul(c, g_A), mul(mul(mul(c, c), m.x2), g_den));
  const float g_x2 = sub(mul(mul(c, c), g_w), mul(c, g_B));
  const float g_c = add(sub(add(mul(mul(2.0f, m.xy), g_t1), mul(m.y2, g_A)), mul(m.x2, g_B)),
                        mul(mul(2.0f, c), mul(m.x2, g_w)));
  gc = add(gc, g_c);
  gx = make_float2(add(add(mul(m.A, gn.x), mul(mul(2.0f, x.x), g_x2)), mul(y.x, g_xy)),
                   add(add(mul(m.A, gn.y), mul(mul(2.0f, x.y), g_x2)), mul(y.y, g_xy)));
  gy = make_float2(add(add(mul(m.Bc, gn.x), mul(mul(2.0f, y.x), g_y2)), mul(x.x, g_xy)),
                   add(add(mul(m.Bc, gn.y), mul(mul(2.0f, y.y), g_y2)), mul(x.y, g_xy)));
}

// Givens rotation of x by g: the gradient of x for gy; gg gets g's.
__device__ __forceinline__ Pair givens_vjp(Pair g, Pair x, const Giv& v, Pair gy, Pair& gg) {
  const float g_cs = add(mul(gy.x, x.x), mul(gy.y, x.y));
  const float g_sn = sub(mul(gy.y, x.x), mul(gy.x, x.y));
  const float g_nq = quo(-add(mul(g_cs, v.cs), mul(g_sn, v.sn)), v.nq);
  const float g_q = pass_min(quo(g_nq, mul(2.0f, v.nq)), v.q, kTiny);
  gg = make_float2(add(quo(g_cs, v.nq), mul(mul(2.0f, g.x), g_q)),
                   add(quo(g_sn, v.nq), mul(mul(2.0f, g.y), g_q)));
  return make_float2(add(mul(v.cs, gy.x), mul(v.sn, gy.y)), sub(mul(v.cs, gy.y), mul(v.sn, gy.x)));
}

// softplus(x) as torch.logaddexp(x, 0) computes it in float32
__device__ __forceinline__ float softplus(float x) {
  return add(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

}  // namespace chain
