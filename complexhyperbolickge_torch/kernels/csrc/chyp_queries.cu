// FFTRotH's query chain, forward and analytic backward, hand-written for
// Hopper (sm_90a): models/chyperbolic.py FFTRotH.get_queries, eager in the
// JAX package (no pallas_call) and in the port's other dtypes and devices.
//
// Row b of the queries (h, r) = (q[b qs], q[b qs + 1]) computes, with
// D = 2R packed reals [Re | Im], n = D - 2 real coordinates (n <= 64):
//   c   = softplus(c[r]) (multi_c), else c[0];  s = sqrt(c)
//   u   = entity[h] Mi                  (irfft_packed: Mi the D x n matrix)
//   hh  = expmap0(u, c);  r1 = expmap0(rel[r][:n], c);  r2 = expmap0(rel[r][n:], c)
//   l   = project(mobius_add(hh, r1, c), c)
//   m2  = mobius_add(givens(rel_diag[r], l), r2, c)
//   res = m2 Mf                         (rfft_packed: Mf the n x D matrix)
// and bias = bh[h].  The pieces are in chyp_chain.cuh.  Mi and Mf are
// ops/fft.py's irfft_matrix and rfft_matrix in fp64.
//
//   fftroth_queries_fwd_kernel   res (B, D) and bias (B)             (1 launch)
//   fftroth_queries_bwd_kernel   recomputes the forward of each row and
//                                writes the row's gradients of its entity
//                                row, rel row, rel_diag row and curvature
//                                (after the softplus) into scratch, and
//                                slot[h] = b
//   fftroth_queries_sum_kernel   the dense gradients of entity (N, D), bh
//                                (N), rel, rel_diag and c: each table row
//                                the fp64 sum of its rows' gradients in
//                                ascending b, rounded once; zeros for a row
//                                no query names            (backward: 2 launches)
// The sum finds the rows of entity row e through slot[e], which it trusts
// only when slot[e] is a row b with h_b == e (then it scans the batch for
// all of them): slot needs no fill, since every named row's entry holds
// one of its rows after the first launch and no other entry can pass the
// test.  No float atomics: the same bits on every run.  A row whose h or r
// lies outside its table gets NaN outputs and adds to no gradient.
//
// Design.  One warp a row, the lane's pair of each real vector in
// registers (chyp_chain.cuh); the block stages the DFT matrices it needs
// into shared memory once and its warps walk the rows (the grid is the
// resident blocks at most).  The forward stages Mi and Mf (2 D n fp64), the
// backward Mi for the recomputed u, Mf^T for the gradient of m2 and Mi^T
// for that of entity[h] (3 D n fp64), each read by the lanes in
// consecutive 8- or 16-byte words.

#include <cuda_runtime.h>

#include <cstdint>

#include "chyp_chain.cuh"

namespace {

using chain::Pair;

constexpr int kWarps = 4;                 // rows a block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kSumThreads = 256;
constexpr int kSumRows = kSumThreads / 32;  // entity rows a sum block
constexpr int kMaxDevices = 64;
constexpr size_t kStaticSmem = 48 * 1024;

struct Tables {
  const float* entity;    // (N, D)
  const float* rel;       // (nR, 2 n)
  const float* rel_diag;  // (nR, n)
  const float* c;         // (nR, 1) with multi_c, else (1, 1)
  const float* bh;        // (N, 1)
};

struct Shape {
  const int64_t* q;  // (B, .) int64, h and r in columns 0 and 1
  long long qs;      // q's row stride
  int B, N, nR, D, multi_c;
};

// Row b's (h, r), or ok = false when either lies outside its table.
struct Ids {
  int h, r;
  bool ok;
};

__device__ __forceinline__ Ids row_ids(const Shape& sh, int b) {
  const long long h = sh.q[(long long)b * sh.qs], r = sh.q[(long long)b * sh.qs + 1];
  Ids id;
  id.ok = h >= 0 && h < sh.N && r >= 0 && r < sh.nR;
  id.h = id.ok ? (int)h : 0;
  id.r = id.ok ? (int)r : 0;
  return id;
}

__device__ __forceinline__ Pair load_pair(const float* p, bool mine) {
  return mine ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

// One row's chain up to m2, with what the backward steps take.
struct Chain {
  float cv, s, rs;
  Pair u, gh, hh, ra, ga, r1, rb, gb, r2, m1, l, rd, gq, m2;
  chain::Exp0 eu, ea, eb;
  chain::Proj pu, pa, pb, pl;
  chain::Mob mo1, mo2;
  chain::Giv gv;
};

// xs: the warp's D fp64 scratch in shared memory; Mi: D x n.
__device__ __forceinline__ void chain_forward(Chain& ch, const Tables& t, const Shape& sh,
                                              Ids id, const double* Mi, double* xs,
                                              int lane) {
  using namespace chain;
  const int D = sh.D, n = D - 2;
  const bool mine = 2 * lane < n;
  for (int j = lane; j < D; j += 32) xs[j] = (double)t.entity[(size_t)id.h * D + j];
  __syncwarp();
  ch.u = times_pair(xs, Mi, D, n, lane);
  const float craw = t.c[sh.multi_c ? id.r : 0];
  ch.cv = sh.multi_c ? softplus(craw) : craw;
  ch.s = __fsqrt_rn(ch.cv);
  ch.rs = __frcp_rn(ch.s);
  const float* rel = t.rel + (size_t)id.r * 2 * n;
  ch.ra = load_pair(rel + 2 * lane, mine);
  ch.rb = load_pair(rel + n + 2 * lane, mine);
  ch.rd = load_pair(t.rel_diag + (size_t)id.r * n + 2 * lane, mine);
  ch.gh = exp0(ch.u, ch.s, ch.eu);
  ch.hh = project(ch.gh, ch.rs, ch.pu);
  ch.ga = exp0(ch.ra, ch.s, ch.ea);
  ch.r1 = project(ch.ga, ch.rs, ch.pa);
  ch.gb = exp0(ch.rb, ch.s, ch.eb);
  ch.r2 = project(ch.gb, ch.rs, ch.pb);
  ch.m1 = mobius_add(ch.hh, ch.r1, ch.cv, ch.mo1);
  ch.l = project(ch.m1, ch.rs, ch.pl);
  ch.gq = givens(ch.rd, ch.l, ch.gv);
  ch.m2 = mobius_add(ch.gq, ch.r2, ch.cv, ch.mo2);
  __syncwarp();  // xs is free again
}

// Copy `count` doubles (count even, both 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(double* dst, const double* __restrict__ src, int count) {
  const double2* s2 = reinterpret_cast<const double2*>(src);
  double2* d2 = reinterpret_cast<double2*>(dst);
  for (int k = threadIdx.x; k < count / 2; k += blockDim.x) d2[k] = s2[k];
}

// ---------------------------------- forward -----------------------------------

// Shared: Mi (D x n), Mf (n x D), then each warp's D fp64 scratch.
__global__ void __launch_bounds__(kThreads)
fftroth_queries_fwd_kernel(Tables t, Shape sh, const double* __restrict__ dft,
                           float* __restrict__ res, float* __restrict__ bias) {
  extern __shared__ double smem_f[];
  const int D = sh.D, n = D - 2, dn = D * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* Mi = smem_f;
  double* Mf = Mi + dn;
  double* xs = Mf + dn + warp * D;
  stage(Mi, dft, dn);
  stage(Mf, dft + dn, dn);
  __syncthreads();
  for (int b = blockIdx.x * kWarps + warp; b < sh.B; b += gridDim.x * kWarps) {
    const Ids id = row_ids(sh, b);
    float* out = res + (size_t)b * D;
    if (!id.ok) {
      for (int j = lane; j < D; j += 32) out[j] = __int_as_float(0x7fffffff);
      if (lane == 0) bias[b] = __int_as_float(0x7fffffff);
      continue;
    }
    Chain ch;
    chain_forward(ch, t, sh, id, Mi, xs, lane);
    chain::put_pair(xs, ch.m2, n, lane);
    __syncwarp();
    chain::times_to(xs, Mf, n, D, lane, out);
    if (lane == 0) bias[b] = t.bh[id.h];
    __syncwarp();
  }
}

// ---------------------------------- backward ----------------------------------

// Row b's gradients into scratch: gx (B, D) of entity[h], grel (B, 2 n) of
// rel[r], grd (B, n) of rel_diag[r], gcv (B) of the curvature c (after the
// softplus); slot[h] = b.  Zeros for a row outside the tables.  Shared: Mi
// (D x n), Mf^T (D x n), Mi^T (n x D), then each warp's D fp64 scratch.
__global__ void __launch_bounds__(kThreads)
fftroth_queries_bwd_kernel(Tables t, Shape sh, const double* __restrict__ dft,
                           const float* __restrict__ g_res, float* __restrict__ gx,
                           float* __restrict__ grel, float* __restrict__ grd,
                           float* __restrict__ gcv, int* __restrict__ slot) {
  using namespace chain;
  extern __shared__ double smem_b[];
  const int D = sh.D, n = D - 2, dn = D * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool mine = 2 * lane < n;
  double* Mi = smem_b;
  double* MfT = Mi + dn;
  double* MiT = MfT + dn;
  double* xs = MiT + dn + warp * D;
  stage(Mi, dft, dn);
  stage(MfT, dft + 2 * dn, dn);
  stage(MiT, dft + 3 * dn, dn);
  __syncthreads();
  for (int b = blockIdx.x * kWarps + warp; b < sh.B; b += gridDim.x * kWarps) {
    const Ids id = row_ids(sh, b);
    float* gx_b = gx + (size_t)b * D;
    float* grel_b = grel + (size_t)b * 2 * n;
    float* grd_b = grd + (size_t)b * n;
    if (!id.ok) {
      for (int j = lane; j < D; j += 32) gx_b[j] = 0.0f;
      for (int j = lane; j < 2 * n; j += 32) grel_b[j] = 0.0f;
      for (int j = lane; j < n; j += 32) grd_b[j] = 0.0f;
      if (lane == 0) gcv[b] = 0.0f;
      continue;
    }
    Chain ch;
    chain_forward(ch, t, sh, id, Mi, xs, lane);
    for (int j = lane; j < D; j += 32) xs[j] = (double)g_res[(size_t)b * D + j];
    __syncwarp();
    const Pair g_m2 = times_pair(xs, MfT, D, n, lane);
    float g_c = 0.0f, g_s = 0.0f, g_rs = 0.0f;
    Pair g_gq, g_r2, g_rd, g_hh, g_r1;
    mobius_add_vjp(ch.gq, ch.r2, ch.cv, ch.mo2, g_m2, g_gq, g_r2, g_c);
    const Pair g_l = givens_vjp(ch.rd, ch.l, ch.gv, g_gq, g_rd);
    const Pair g_m1 = project_vjp(ch.m1, ch.pl, g_l, g_rs);
    mobius_add_vjp(ch.hh, ch.r1, ch.cv, ch.mo1, g_m1, g_hh, g_r1, g_c);
    const Pair g_u = exp0_vjp(ch.u, ch.gh, ch.s, ch.eu, project_vjp(ch.gh, ch.pu, g_hh, g_rs), g_s);
    const Pair g_ra = exp0_vjp(ch.ra, ch.ga, ch.s, ch.ea, project_vjp(ch.ga, ch.pa, g_r1, g_rs), g_s);
    const Pair g_rb = exp0_vjp(ch.rb, ch.gb, ch.s, ch.eb, project_vjp(ch.gb, ch.pb, g_r2, g_rs), g_s);
    // s = sqrt(c) and rs = 1 / s
    g_s = add(g_s, mul(-g_rs, mul(ch.rs, ch.rs)));
    g_c = add(g_c, quo(mul(g_s, 0.5f), ch.s));
    __syncwarp();  // every lane has read xs
    put_pair(xs, g_u, n, lane);
    __syncwarp();
    times_to(xs, MiT, n, D, lane, gx_b);
    if (mine) {
      *reinterpret_cast<float2*>(grel_b + 2 * lane) = g_ra;
      *reinterpret_cast<float2*>(grel_b + n + 2 * lane) = g_rb;
      *reinterpret_cast<float2*>(grd_b + 2 * lane) = g_rd;
    }
    if (lane == 0) {
      gcv[b] = g_c;
      slot[id.h] = b;
    }
    __syncwarp();
  }
}

// Row b's key in a table: its h (entity), r (rel, rel_diag) or its
// curvature row (c); -1 for a row outside the tables.
enum Kind { kEntity = 0, kRel = 1, kCurv = 2 };

__device__ __forceinline__ int row_key(const Shape& sh, int b, int kind) {
  const Ids id = row_ids(sh, b);
  if (!id.ok) return -1;
  return kind == kEntity ? id.h : (kind == kRel || sh.multi_c ? id.r : 0);
}

// Blocks [0, eb): kSumRows entity rows each, one warp a row: entity row e
// and bh[e] (D + 1 columns) from slot[e].  Then nR blocks of relation rows
// (rel's 2 n and rel_diag's n columns, a thread a column), then n_c of
// curvature rows (thread 0), each collecting its rows b in ascending
// order a block-wide chunk at a time.
__global__ void __launch_bounds__(kSumThreads)
fftroth_queries_sum_kernel(Shape sh, const float* __restrict__ c, const float* __restrict__ gx,
                           const float* __restrict__ g_bias, const float* __restrict__ grel,
                           const float* __restrict__ grd, const float* __restrict__ gcv,
                           const int* __restrict__ slot, float* __restrict__ d_entity,
                           float* __restrict__ d_bh, float* __restrict__ d_rel,
                           float* __restrict__ d_rd, float* __restrict__ d_c, int eb, int n_c) {
  using namespace chain;
  const int D = sh.D, n = D - 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < eb) {
    const int e = blockIdx.x * kSumRows + warp;
    if (e >= sh.N) return;
    const int s = slot[e];  // trusted only if row s names e
    const bool named = s >= 0 && s < sh.B && row_key(sh, s, kEntity) == e;
    double acc[3] = {0.0, 0.0, 0.0};
    if (named) {
      for (int b0 = 0; b0 < sh.B; b0 += 32) {
        const int b = b0 + lane;
        unsigned hit = __ballot_sync(kFull, b < sh.B && row_key(sh, b, kEntity) == e);
        while (hit) {
          const int bb = b0 + __ffs(hit) - 1;
          hit &= hit - 1;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int j = lane + 32 * k;
            if (j < D) acc[k] = __dadd_rn(acc[k], (double)gx[(size_t)bb * D + j]);
            else if (j == D && g_bias) acc[k] = __dadd_rn(acc[k], (double)g_bias[bb]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = lane + 32 * k;
      if (j < D) d_entity[(size_t)e * D + j] = rnd(acc[k]);
      else if (j == D) d_bh[e] = rnd(acc[k]);
    }
    return;
  }
  const int kind = (int)blockIdx.x < eb + sh.nR ? kRel : kCurv;
  const int key = blockIdx.x - eb - (kind == kRel ? 0 : sh.nR);
  const int cols = kind == kRel ? 3 * n : 1;
  const int col = threadIdx.x;
  __shared__ int list_s[kSumThreads];
  __shared__ int count_s[kSumThreads / 32];
  double acc = 0.0;
  for (int b0 = 0; b0 < sh.B; b0 += kSumThreads) {
    const int b = b0 + threadIdx.x;
    const bool hit = b < sh.B && row_key(sh, b, kind) == key;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) count_s[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kSumThreads / 32; ++w) {
      before += w < warp ? count_s[w] : 0;
      total += count_s[w];
    }
    if (hit) list_s[before + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    if (col < cols) {
      for (int k = 0; k < total; ++k) {
        const int bb = list_s[k];
        const float v = kind == kCurv ? gcv[bb]
                        : col < 2 * n ? grel[(size_t)bb * 2 * n + col]
                                      : grd[(size_t)bb * n + col - 2 * n];
        acc = __dadd_rn(acc, (double)v);
      }
    }
    __syncthreads();  // list_s and count_s are refilled next
  }
  if (col >= cols) return;
  if (kind == kCurv) {
    // the softplus' gradient: grad / (1 + exp(0 - c)), after the sum
    const float g = rnd(acc);
    d_c[key] = sh.multi_c ? quo(g, add(1.0f, expf(sub(0.0f, c[key])))) : g;
  } else if (col < 2 * n) {
    d_rel[(size_t)key * 2 * n + col] = rnd(acc);
  } else {
    d_rd[(size_t)key * n + col - 2 * n] = rnd(acc);
  }
}

// ------------------------------- launch sizes ---------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t fwd_smem(int D) { return (2 * (size_t)D * (D - 2) + kWarps * (size_t)D) * sizeof(double); }
size_t bwd_smem(int D) { return (3 * (size_t)D * (D - 2) + kWarps * (size_t)D) * sizeof(double); }

// The resident blocks of `kernel` at `smem` bytes on the current device
// (cached per device and kernel, which fixes D for a process's model).
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return 0;
}

int fwd_cache[kMaxDevices] = {0};
int bwd_cache[kMaxDevices] = {0};
int fwd_d[kMaxDevices] = {0};
int bwd_d[kMaxDevices] = {0};

// The grid for B rows: one warp a row, at most the resident blocks.
template <typename Kernel>
int row_grid(Kernel kernel, size_t smem, int D, int B, int* cache, int* cached_d,
             unsigned* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached_d[dev] != D) {  // another width: another shared size
    cache[dev] = 0;
    cached_d[dev] = D;
  }
  int blocks = 0;
  const int rc = resident_blocks(kernel, smem, cache, &blocks);
  if (rc != 0) return rc;
  const long long need = ((long long)B + kWarps - 1) / kWarps;
  *grid = (unsigned)(need < blocks ? need : blocks);
  return 0;
}

bool bad_shape(int B, int N, int nR, int D) {
  return B < 1 || N < 1 || nR < 1 || D < 4 || D % 2 || D - 2 > chain::kMaxN;
}

}  // namespace

// C interface, loaded with ctypes.  Each launcher enqueues on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take (B, N, nR < 1; D odd,
// below 4 or above 66).  Tables are contiguous float32 (entity (N, D), rel
// (nR, 2 (D - 2)), rel_diag (nR, D - 2), c (nR or 1), bh (N)), 8-byte
// aligned; q (B, >= 2) int64 rows qs apart; dft the fp64 matrices Mi (D x
// n), Mf (n x D), Mf^T, Mi^T one after another (16-byte aligned).
extern "C" int fftroth_queries_fwd(const float* entity, const float* rel, const float* rel_diag,
                                   const float* c, const float* bh, const int64_t* q, int qs,
                                   const double* dft, float* res, float* bias, int B, int N,
                                   int nR, int D, int multi_c, cudaStream_t stream) {
  if (bad_shape(B, N, nR, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  unsigned grid = 0;
  const int rc = row_grid(fftroth_queries_fwd_kernel, smem, D, B, fwd_cache, fwd_d, &grid);
  if (rc != 0) return rc;
  const Tables t{entity, rel, rel_diag, c, bh};
  const Shape sh{q, (long long)qs, B, N, nR, D, multi_c};
  fftroth_queries_fwd_kernel<<<grid, kThreads, smem, stream>>>(t, sh, dft, res, bias);
  return (int)cudaGetLastError();
}

// The backward's two launches for the cotangents g_res (B, D) and g_bias
// (B; NULL: zero): d_entity (N, D), d_bh (N), d_rel, d_rel_diag, d_c (nR
// with multi_c, else 1) are written whole.  Scratch: gx (B D), grel
// (B 2 n), grd (B n), gcv (B) float32 and slot (N) int32, none filled.
extern "C" int fftroth_queries_bwd(const float* entity, const float* rel, const float* rel_diag,
                                   const float* c, const int64_t* q, int qs, const double* dft,
                                   const float* g_res, const float* g_bias, float* gx,
                                   float* grel, float* grd, float* gcv, int* slot,
                                   float* d_entity, float* d_bh, float* d_rel, float* d_rd,
                                   float* d_c, int B, int N, int nR, int D, int multi_c,
                                   cudaStream_t stream) {
  if (bad_shape(B, N, nR, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  unsigned grid = 0;
  const int rc = row_grid(fftroth_queries_bwd_kernel, smem, D, B, bwd_cache, bwd_d, &grid);
  if (rc != 0) return rc;
  const Tables t{entity, rel, rel_diag, c, nullptr};
  const Shape sh{q, (long long)qs, B, N, nR, D, multi_c};
  fftroth_queries_bwd_kernel<<<grid, kThreads, smem, stream>>>(t, sh, dft, g_res, gx, grel,
                                                               grd, gcv, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int eb = (N + kSumRows - 1) / kSumRows;
  const int n_c = multi_c ? nR : 1;
  fftroth_queries_sum_kernel<<<eb + nR + n_c, kSumThreads, 0, stream>>>(
      sh, c, gx, g_bias, grel, grd, gcv, slot, d_entity, d_bh, d_rel, d_rd, d_c, eb, n_c);
  return (int)cudaGetLastError();
}
