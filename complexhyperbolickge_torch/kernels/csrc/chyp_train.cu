// Train-mode complex-hyperbolic distance of queries against entity rows
// picked by id, forward and analytic backward, hand-written for Hopper
// (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/chyp_train.py composed with the
// candidate gather the JAX model does in XLA, d = chyp_train_distance(lhs,
// entity[ids]):
//   chyp_train_fwd    <- _fwd_call / _fwd_kernel              (K3)
//   chyp_train_bwd    <- _bwd_call / _bwd_kernel, plus the
//                        d_lhs assembly of _ctd_bwd and the
//                        gather's backward into the table     (K4)
//   chyp_train_lists     K4's index preparation: each table
//                        row's pairs, in ascending order
//
// Pair p = b K + k scores query b (lhs row z, D = 2R packed reals
// [Re | Im]) against table row e = ids[p] (w):
//   sr = <z, w> - 1,  si = <swap_neg(z), w>,  swap_neg(z) = [Im | -Re]
//   zn = clip(|z|^2 - 1, -1, -eps),  wn = clip(|w|^2 - 1, -1, -eps)
//   x  = max(2 (sr^2 + si^2) / (zn wn) - 1, 1 + eps),  d = log(x + sqrt(x^2 - 1))
// K3 writes d and the residuals sr, si, wn, x (B, K) and zn (B).  K4 takes
// the cotangent g (B, K) and the residuals and evaluates the reference's
// Distance.backward with each side's denominator clamped,
//   p_z = min(sqrt(x^2 - 1) zn^2 wn, -eps),  p_w = min(sqrt(x^2 - 1) wn^2 zn, -eps)
//   ca_z = 4 g sr zn / p_z,  cb_z = 4 g si zn / p_z,  cz = -4 g a2 / p_z
//   ca_w = 4 g sr wn / p_w,  cb_w = 4 g si wn / p_w,  cw = -4 g a2 / p_w
//   d_lhs[b]   = m_a - swap_neg(m_b) + (sum_k cz[p]) z,
//                m_a = sum_k ca_z[p] w_p,  m_b = sum_k cb_z[p] w_p
//   d_table[e] = sum over the pairs p with ids[p] = e, in ascending p, of
//                ca_w[p] z_b + cb_w[p] swap_neg(z_b) + cw[p] w_e
// (a2 = sr^2 + si^2); a row no pair names gets zeros.  Without ids (the
// identity form) pair p reads table row p, so d_table is the gathered
// form's d_rhs.  The dot products and the sums accumulate in fp64 (f32
// products are exact there) and round once to f32; the plain version does
// the same, so the two agree to the ulp whatever their summation order.
// Each pair's d_table term is formed in f32 first, as the gathered form's
// d_rhs element, so a row with one pair gets exactly that element.  The
// f32 arithmetic is spelled out in round-to-nearest intrinsics in the
// order of the JAX expressions, so no contraction choice of the compiler
// moves a result, and acosh is log(x + sqrt(x^2 - 1)) as in the TPU kernel
// and the plain version.  Clamps keep NaN as jnp.clip does.  An id outside
// [0, N) reads nothing: its pair's outputs are NaN and it adds to no row.
//
// Bound on an H100 SXM at the WN18RR train step (B = 500, 1 + K = 101,
// D = 66, N = 40,943): bytes.  The 50,500 ids name ~29,000 distinct rows
// (7.7 MB); with the ids, lhs and the (B, K) outputs K3 moves ~9 MB, ~2.7
// us at 3.35 TB/s, against 3 D fp64 FMAs a pair (~0.6 us at 34 TFLOP/s).
// K4 reads those rows, g and the residuals and writes d_lhs and the dense
// (N, D) gradient (10.8 MB), ~20 MB, ~6 us.  Tensor cores cannot help: each
// dot is one row against one row, and exact.
//
// Design.  Every step of a dependent chain of loads costs a round trip to
// L2 or HBM, so each kernel issues its loads in a few wide rounds.
//  * K3's grid runs over tiles of 128 pairs, not queries (K = 1 fills the
//    card as K = 100 does), one thread a pair.  A block loads its tile's row
//    ids, then copies the tile's rows (cp.async, 8 bytes a copy: rows are
//    8-byte aligned for even D) and the query rows it spans (as fp64, with
//    swap_neg(z)) into shared memory in one round, a column chunk at a time
//    for wide rows.  Each thread runs its pair's three fp64 dots and its
//    epilogue alone: no shuffles, one epilogue a pair (a group of 8 lanes a
//    pair, reducing by shuffles and running the epilogue on all 8, took
//    0.0114-0.0140 ms on the H100 against 0.0092 for this).
//  * chyp_train_lists (one cooperative launch, grid.sync() between phases)
//    counts the ids with integer atomics, scans the counts into CSR offsets,
//    scatters each pair into its row's segment and then places each pair at
//    its rank among the segment's smaller pair indices: a stable counting
//    sort, whatever order the scatter took.  With each pair it stores the
//    three table-side coefficients, so K4's row blocks read one 16-byte
//    record a pair.  (torch.sort of the 50,500 int64 ids took 0.094 ms and
//    22 device operations on the H100.)
//  * K4 is one launch in two roles.  Blocks below B take a query each: the
//    block computes its candidates' query-side coefficients and copies their
//    rows into shared memory (cp.async) in one round, then 16-lane groups
//    accumulate m_a, m_b in fp64 and the warps combine in a fixed order.
//    The other blocks take 32 table rows each, one group a row: it reads the
//    row's segment of records in order and writes every column, zeros for a
//    row no pair names, so nothing fills the gradient first.
// No float atomics: the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePairs = 128;            // K3: pairs (and threads) a block
constexpr int kG = 8;                      // lanes a row in K4's row blocks
constexpr int kGroups = kThreads / kG;     // 32
constexpr int kGA = 16;                    // lanes a candidate in K4's query blocks
constexpr int kGroupsA = kThreads / kGA;   // 16
constexpr int kMaxV = 8;                   // float2 a lane a chunk in the row blocks
constexpr int kMaxCols = 128;              // columns a staged chunk
// K4's resident blocks an SM, which caps its registers at 80 (at 4 blocks
// and 64 registers it spilled 80 bytes and ran 1.24x slower, at 2 and 96
// registers 1.16x slower on the H100)
constexpr int kMinBlocks = 3;
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;    // opt-in limit of a block
constexpr size_t kQueryStage = 32 * 1024;  // K4 query blocks: bytes of staged rows a tile
constexpr size_t kFwdStage = 64 * 1024;    // K3: shared bytes a block at most

// clip(v, -1, -eps), keeping NaN
__device__ __forceinline__ float clamp_norm(float v, float eps) {
  v = (v < -1.0f) ? -1.0f : v;
  return (v > -eps) ? -eps : v;
}

// swap_neg of a packed row: [Im | -Re]
__device__ __forceinline__ float swapped(const float* v, int i, int R) {
  return (i < R) ? v[i + R] : -v[i - R];
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fffffff); }

// 8-byte asynchronous copy into shared memory, and the wait for all of a
// thread's copies.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Table row of pair p, or -1 for an id outside [0, n_rows).
__device__ __forceinline__ int pair_row(const int64_t* ids, long long p, long long n_rows) {
  const long long e = ids ? (long long)ids[p] : p;
  return (e >= 0 && e < n_rows) ? (int)e : -1;
}

struct Fwd {
  float d, sr, si, wn, x;
};

// K3's epilogue from the three fp64 dots.
__device__ __forceinline__ Fwd epilogue(double a_re, double a_im, double a_ww, float zn,
                                        float eps, float x_min) {
  Fwd o;
  o.sr = __double2float_rn(__dsub_rn(a_re, 1.0));
  o.si = __double2float_rn(a_im);
  o.wn = clamp_norm(__double2float_rn(__dsub_rn(a_ww, 1.0)), eps);
  const float a2 = __fadd_rn(__fmul_rn(o.sr, o.sr), __fmul_rn(o.si, o.si));
  const float x = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, a2), __fmul_rn(zn, o.wn)), 1.0f);
  o.x = (x < x_min) ? x_min : x;
  o.d = logf(__fadd_rn(o.x, __fsqrt_rn(__fsub_rn(__fmul_rn(o.x, o.x), 1.0f))));
  return o;
}

struct Coef {
  float ca_z, cb_z, cz, ca_w, cb_w, cw;
};

// K4's six coefficients of pair p (zn_b: its query's clamped norm).
__device__ __forceinline__ Coef coefficients(const float* g, const float* sr, const float* si,
                                             const float* wn, const float* x, long long p,
                                             float zn_b, float eps) {
  const float gk = g[p], s_r = sr[p], s_i = si[p], w_n = wn[p], xk = x[p];
  const float a2 = __fadd_rn(__fmul_rn(s_r, s_r), __fmul_rn(s_i, s_i));
  const float sq = __fsqrt_rn(__fsub_rn(__fmul_rn(xk, xk), 1.0f));
  float p_z = __fmul_rn(__fmul_rn(__fmul_rn(sq, zn_b), zn_b), w_n);
  float p_w = __fmul_rn(__fmul_rn(__fmul_rn(sq, w_n), w_n), zn_b);
  p_z = (p_z > -eps) ? -eps : p_z;  // min(p, -eps), keeping NaN
  p_w = (p_w > -eps) ? -eps : p_w;
  const float g4 = __fmul_rn(gk, 4.0f);
  const float gm4 = __fmul_rn(gk, -4.0f);
  Coef c;
  c.ca_z = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_r), zn_b), p_z);
  c.cb_z = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_i), zn_b), p_z);
  c.cz = __fdiv_rn(__fmul_rn(gm4, a2), p_z);
  c.ca_w = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_r), w_n), p_w);
  c.cb_w = __fdiv_rn(__fmul_rn(__fmul_rn(g4, s_i), w_n), p_w);
  c.cw = __fdiv_rn(__fmul_rn(gm4, a2), p_w);
  return c;
}

// Copy columns [c0, c0 + cw) of each of n rows (rows[i]: a table row, or
// -1 for none) into dst[i * pitch ...] with 8-byte cp.async; all
// `threads` threads of the block take part.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ table,
                                           const int* rows, int n, int D, int c0, int cw,
                                           int pitch, int threads) {
  const int half = cw / 2;
  for (int i = threadIdx.x; i < n * half; i += threads) {
    const int li = i / half, c = 2 * (i - li * half);
    const int e = rows[li];
    if (e >= 0) cp_async8(dst + li * pitch + c, table + (size_t)e * D + c0 + c);
  }
}

// ------------------------------------ K3 -------------------------------------

// One thread a pair: pairs [p0, p0 + kTilePairs) a block.  For each column
// chunk of cw the block copies its pairs' rows (pitch floats apart) and the
// query rows they span (z and swap_neg(z) in fp64) into shared memory; each
// thread then runs its pair's three dots over the chunk in column order,
// and after the last chunk its epilogue.  Shared: z, swap_neg(z)
// [nq_max][cw] and |z|^2 [nq_max] (fp64), rows [kTilePairs][pitch], zn
// [nq_max], row ids [kTilePairs].
__global__ void __launch_bounds__(kTilePairs)
chyp_train_fwd_kernel(const float* __restrict__ lhs, const float* __restrict__ table,
                      const int64_t* __restrict__ ids, long long n_rows,
                      float* __restrict__ d_out, float* __restrict__ sr_out,
                      float* __restrict__ si_out, float* __restrict__ wn_out,
                      float* __restrict__ x_out, float* __restrict__ zn_out, int K, int D,
                      int cw, int pitch, int nq_max, long long n_pairs, float eps,
                      float x_min) {
  extern __shared__ double smem_f[];
  double* z_s = smem_f;                                    // [nq_max][cw]
  double* zsw_s = z_s + (size_t)nq_max * cw;               // [nq_max][cw]
  double* zz_s = zsw_s + (size_t)nq_max * cw;              // [nq_max]
  float* w_s = reinterpret_cast<float*>(zz_s + nq_max);    // [kTilePairs][pitch]
  float* zn_s = w_s + (size_t)kTilePairs * pitch;          // [nq_max]
  int* row_s = reinterpret_cast<int*>(zn_s + nq_max);      // [kTilePairs]

  const long long p0 = (long long)blockIdx.x * kTilePairs;
  const int np = (int)((n_pairs - p0 < kTilePairs) ? n_pairs - p0 : kTilePairs);
  const long long b0 = p0 / K;
  const int r0 = (int)(p0 - b0 * K);  // p0's candidate index in query b0
  const int nq = (r0 + np - 1) / K + 1;
  const int R = D / 2;
  const int t = threadIdx.x;
  const int q = (r0 + t) / K;  // this thread's query among the staged ones
  const float* zsrc = lhs + b0 * D;

  if (t < np) row_s[t] = pair_row(ids, p0 + t, n_rows);
  for (int i = t; i < nq; i += kTilePairs) zz_s[i] = 0.0;
  __syncthreads();
  double re = 0.0, im = 0.0, ww = 0.0;
  for (int c0 = 0; c0 < D; c0 += cw) {
    const int w = (D - c0 < cw) ? D - c0 : cw;
    stage_rows(w_s, table, row_s, np, D, c0, w, pitch, kTilePairs);
    for (int i = t; i < nq * w; i += kTilePairs) {
      const int qi = i / w, c = c0 + i - qi * w;
      const float* zq = zsrc + (size_t)qi * D;
      z_s[qi * cw + c - c0] = zq[c];
      zsw_s[qi * cw + c - c0] = swapped(zq, c, R);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int qi = t; qi < nq; qi += kTilePairs) {
      double a = zz_s[qi];
      for (int i = 0; i < w; ++i) a = __fma_rn(z_s[qi * cw + i], z_s[qi * cw + i], a);
      zz_s[qi] = a;
    }
    if (t < np) {
      const float* wr = w_s + t * pitch;
      const double* zq = z_s + q * cw;
      const double* sq = zsw_s + q * cw;
      for (int i = 0; i < w; i += 2) {
        const float2 w2 = *reinterpret_cast<const float2*>(wr + i);
        const double2 z2 = *reinterpret_cast<const double2*>(zq + i);
        const double2 s2 = *reinterpret_cast<const double2*>(sq + i);
        const double w0 = w2.x, w1 = w2.y;
        re = __fma_rn(z2.x, w0, re);
        re = __fma_rn(z2.y, w1, re);
        im = __fma_rn(s2.x, w0, im);
        im = __fma_rn(s2.y, w1, im);
        ww = __fma_rn(w0, w0, ww);
        ww = __fma_rn(w1, w1, ww);
      }
    }
    __syncthreads();  // the chunk's buffers are refilled next
  }
  for (int qi = t; qi < nq; qi += kTilePairs) {
    const float zn = clamp_norm(__double2float_rn(__dsub_rn(zz_s[qi], 1.0)), eps);
    zn_s[qi] = zn;
    if (qi > 0 || r0 == 0) zn_out[b0 + qi] = zn;  // the block of the query's first pair
  }
  __syncthreads();
  if (t < np) {
    Fwd o = epilogue(re, im, ww, zn_s[q], eps, x_min);
    if (row_s[t] < 0) o = Fwd{nan_f32(), nan_f32(), nan_f32(), nan_f32(), nan_f32()};
    const long long p = p0 + t;
    d_out[p] = o.d;
    sr_out[p] = o.sr;
    si_out[p] = o.si;
    wn_out[p] = o.wn;
    x_out[p] = o.x;
  }
}

// ----------------------------- K4's pair lists --------------------------------

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += (w < warp) ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = all;
  return before + inc - v;
}

// Pair p's record for K4's row blocks: {p as bits, ca_w, cb_w, cw}.
__device__ __forceinline__ float4 pair_record(const float* g, const float* sr,
                                              const float* si, const float* wn,
                                              const float* x, const float* zn, int p, int K,
                                              float eps) {
  const Coef c = coefficients(g, sr, si, wn, x, p, zn[p / K], eps);
  return make_float4(__int_as_float(p), c.ca_w, c.cb_w, c.cw);
}

// Each table row's pairs in ascending order with their records: offsets
// (n_rows + 1) and lists (the records, row by row).  A stable counting sort
// of the ids (in [0, n_rows); others are left out), in one cooperative
// launch: every block is resident and grid.sync() separates the phases.
// cursor (n_rows), unsorted (n_pairs) and totals (gridDim.x) are scratch.
// Without ids (the identity form) pair p is row p's only pair.
__global__ void __launch_bounds__(kThreads)
chyp_train_lists_kernel(const int64_t* __restrict__ ids, const float* __restrict__ g,
                        const float* __restrict__ sr, const float* __restrict__ si,
                        const float* __restrict__ wn, const float* __restrict__ x,
                        const float* __restrict__ zn, int n_pairs, int n_rows, int K,
                        float eps, int* __restrict__ offsets, float4* __restrict__ lists,
                        int* __restrict__ cursor, int* __restrict__ unsorted,
                        int* __restrict__ totals) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  if (ids == nullptr) {  // the same branch in every block: no grid.sync() is skipped
    for (int e = tid; e <= n_rows; e += stride) offsets[e] = e;
    for (int p = tid; p < n_pairs; p += stride)
      lists[p] = pair_record(g, sr, si, wn, x, zn, p, K, eps);
    return;
  }
  for (int e = tid; e < n_rows; e += stride) cursor[e] = 0;
  grid.sync();
  for (int p = tid; p < n_pairs; p += stride) {
    const long long e = ids[p];
    if (e >= 0 && e < n_rows) atomicAdd(&cursor[e], 1);
  }
  grid.sync();
  // block b scans rows [lo, hi), each thread a contiguous run of them
  const int per_block = (n_rows + gridDim.x - 1) / gridDim.x;
  const int lo = min(n_rows, (int)blockIdx.x * per_block);
  const int hi = min(n_rows, lo + per_block);
  const int run = (per_block + kThreads - 1) / kThreads;
  const int t0 = min(hi, lo + (int)threadIdx.x * run), t1 = min(hi, t0 + run);
  int mine = 0;
  for (int e = t0; e < t1; ++e) mine += cursor[e];
  int block_total;
  const int excl = block_exclusive_scan(mine, &block_total);
  if (threadIdx.x == 0) totals[blockIdx.x] = block_total;
  grid.sync();
  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads) before += totals[b];
  int earlier;
  block_exclusive_scan(before, &earlier);
  int at = earlier + excl;
  for (int e = t0; e < t1; ++e) {
    const int c = cursor[e];
    offsets[e] = at;
    cursor[e] = at;  // the scatter's cursor starts at the row's offset
    at += c;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kThreads - 1) offsets[n_rows] = at;
  grid.sync();
  for (int p = tid; p < n_pairs; p += stride) {
    const long long e = ids[p];
    if (e >= 0 && e < n_rows) unsorted[atomicAdd(&cursor[e], 1)] = p;
  }
  grid.sync();
  // each pair's place: its row's offset plus the row's smaller pairs
  for (int p = tid; p < n_pairs; p += stride) {
    const long long e = ids[p];
    if (e < 0 || e >= n_rows) continue;
    const int a = offsets[e], z = offsets[e + 1];
    int rank = 0;
    for (int j = a; j < z; ++j) rank += unsorted[j] < p;
    lists[a + rank] = pair_record(g, sr, si, wn, x, zn, p, K, eps);
  }
}

// ------------------------------------ K4 -------------------------------------

// d_lhs of query b = blockIdx.x.  For each column chunk and tile of up to
// kt candidates, the block computes the candidates' query-side
// coefficients and copies their rows' chunk into shared memory; 16-lane
// groups accumulate m_a, m_b (fp64) over candidates k = j, j + 16, ...; the
// two groups of a warp combine by butterfly, the warps in order through
// shared memory.  Shared: the warps' partials [kWarps][2][cw] and cz sums
// [kWarps] (fp64); m_a, m_b [D]; the tile's rows [kt][cw], coefficients
// [3][kt] and row ids [kt].
template <int VA>
__device__ __forceinline__ void bwd_query(const float* __restrict__ g,
                                          const float* __restrict__ lhs,
                                          const float* __restrict__ table,
                                          const int64_t* __restrict__ ids, long long n_rows,
                                          const float* __restrict__ sr,
                                          const float* __restrict__ si,
                                          const float* __restrict__ wn,
                                          const float* __restrict__ x,
                                          const float* __restrict__ zn,
                                          float* __restrict__ d_lhs, int K, int D, int cw,
                                          int kt, float eps, double* smem_d) {
  double* red = smem_d;                                   // [kWarps][2][cw]
  double* czw = red + kWarps * 2 * cw;                    // [kWarps]
  float* ma_s = reinterpret_cast<float*>(czw + kWarps);  // [D]
  float* mb_s = ma_s + D;                                 // [D]
  float* w_s = mb_s + D;                                  // [kt][cw]
  float* ca_s = w_s + kt * cw;                            // [kt]
  float* cb_s = ca_s + kt;                                // [kt]
  float* cz_s = cb_s + kt;                                // [kt]
  int* row_s = reinterpret_cast<int*>(cz_s + kt);         // [kt]
  __shared__ float czs_s;

  const int b = blockIdx.x;
  const int R = D / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = threadIdx.x / kGA, r = threadIdx.x % kGA;
  const float zn_b = zn[b];
  const long long pb = (long long)b * K;

  for (int c0 = 0; c0 < D; c0 += cw) {
    const int w = (D - c0 < cw) ? D - c0 : cw;
    double ma[2 * VA], mb[2 * VA], czs = 0.0;
#pragma unroll
    for (int t = 0; t < 2 * VA; ++t) ma[t] = mb[t] = 0.0;
    for (int k0 = 0; k0 < K; k0 += kt) {
      const int nk = (K - k0 < kt) ? K - k0 : kt;
      __syncthreads();  // the previous tile's buffers are read
      for (int t = threadIdx.x; t < nk; t += kThreads) row_s[t] = pair_row(ids, pb + k0 + t, n_rows);
      __syncthreads();
      stage_rows(w_s, table, row_s, nk, D, c0, w, cw, kThreads);
      for (int t = threadIdx.x; t < nk; t += kThreads) {
        const Coef cf = coefficients(g, sr, si, wn, x, pb + k0 + t, zn_b, eps);
        ca_s[t] = cf.ca_z;
        cb_s[t] = cf.cb_z;
        cz_s[t] = cf.cz;
      }
      cp_async_wait_all();
      __syncthreads();
      for (int k = grp; k < nk; k += kGroupsA) {
        const double ca = ca_s[k], cb = cb_s[k];
        const float* wk = w_s + k * cw;
#pragma unroll
        for (int t = 0; t < VA; ++t) {
          const int i = 2 * (r + t * kGA);
          if (i < w) {
            const float2 w2 = *reinterpret_cast<const float2*>(wk + i);
            ma[2 * t] = __fma_rn(ca, (double)w2.x, ma[2 * t]);
            ma[2 * t + 1] = __fma_rn(ca, (double)w2.y, ma[2 * t + 1]);
            mb[2 * t] = __fma_rn(cb, (double)w2.x, mb[2 * t]);
            mb[2 * t + 1] = __fma_rn(cb, (double)w2.y, mb[2 * t + 1]);
          }
        }
        czs = __dadd_rn(czs, (double)cz_s[k]);
      }
    }
    __syncwarp();
    // the warp's two groups: lanes r and r + 16
#pragma unroll
    for (int t = 0; t < 2 * VA; ++t) {
      ma[t] = __dadd_rn(ma[t], __shfl_xor_sync(0xffffffffu, ma[t], kGA));
      mb[t] = __dadd_rn(mb[t], __shfl_xor_sync(0xffffffffu, mb[t], kGA));
    }
    czs = __dadd_rn(czs, __shfl_xor_sync(0xffffffffu, czs, kGA));
    if (lane < kGA) {
#pragma unroll
      for (int t = 0; t < VA; ++t) {
        const int i = 2 * (r + t * kGA);
        if (i < w) {
          red[(warp * 2) * cw + i] = ma[2 * t];
          red[(warp * 2) * cw + i + 1] = ma[2 * t + 1];
          red[(warp * 2 + 1) * cw + i] = mb[2 * t];
          red[(warp * 2 + 1) * cw + i + 1] = mb[2 * t + 1];
        }
      }
      if (lane == 0) czw[warp] = czs;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < w; i += kThreads) {
      double a = red[i], m = red[cw + i];
      for (int v = 1; v < kWarps; ++v) {
        a = __dadd_rn(a, red[(v * 2) * cw + i]);
        m = __dadd_rn(m, red[(v * 2 + 1) * cw + i]);
      }
      ma_s[c0 + i] = __double2float_rn(a);
      mb_s[c0 + i] = __double2float_rn(m);
    }
    if (c0 == 0 && threadIdx.x == 0) {
      double s = czw[0];
      for (int v = 1; v < kWarps; ++v) s = __dadd_rn(s, czw[v]);
      czs_s = __double2float_rn(s);
    }
    __syncthreads();
  }
  const float* z = lhs + (size_t)b * D;
  for (int d = threadIdx.x; d < D; d += kThreads)
    d_lhs[(size_t)b * D + d] =
        __fadd_rn(__fsub_rn(ma_s[d], swapped(mb_s, d, R)), __fmul_rn(czs_s, z[d]));
}

// Row e of d_table: one group reads the row's records
// lists[offsets[e] .. offsets[e + 1]) in order, V float2 a lane a chunk of
// 16 V columns, and writes every column, zeros for no pair.
template <int V>
__device__ __forceinline__ void bwd_row(int e, const float* __restrict__ lhs,
                                        const float* __restrict__ table,
                                        const int* __restrict__ offsets,
                                        const float4* __restrict__ lists,
                                        float* __restrict__ d_table, int K, int D) {
  constexpr int kCW = 2 * kG * V;
  const int R = D / 2;
  const int r = threadIdx.x % kG;
  const float* w = table + (size_t)e * D;
  float* out = d_table + (size_t)e * D;
  const int nch = (D + kCW - 1) / kCW;
  const int lo = offsets[e], hi = offsets[e + 1];
  for (int c = 0; c < nch; ++c) {
    float2 wv[V];
    double acc[2 * V];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int i = c * kCW + 2 * (r + t * kG);
      wv[t] = (hi > lo && i < D) ? __ldg(reinterpret_cast<const float2*>(w + i))
                                 : make_float2(0.0f, 0.0f);
      acc[2 * t] = acc[2 * t + 1] = 0.0;
    }
    float4 rec = (hi > lo) ? __ldg(lists + lo) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = lo; j < hi; ++j) {
      const float4 next = (j + 1 < hi) ? __ldg(lists + j + 1) : rec;
      const int p = __float_as_int(rec.x);
      const float* z = lhs + (size_t)(p / K) * D;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int i = c * kCW + 2 * (r + t * kG);
        if (i < D) {
          const float2 z2 = __ldg(reinterpret_cast<const float2*>(z + i));
          const float t0 = __fadd_rn(__fadd_rn(__fmul_rn(rec.y, z2.x),
                                               __fmul_rn(rec.z, swapped(z, i, R))),
                                     __fmul_rn(rec.w, wv[t].x));
          const float t1 = __fadd_rn(__fadd_rn(__fmul_rn(rec.y, z2.y),
                                               __fmul_rn(rec.z, swapped(z, i + 1, R))),
                                     __fmul_rn(rec.w, wv[t].y));
          acc[2 * t] = __dadd_rn(acc[2 * t], (double)t0);
          acc[2 * t + 1] = __dadd_rn(acc[2 * t + 1], (double)t1);
        }
      }
      rec = next;
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int i = c * kCW + 2 * (r + t * kG);
      if (i < D)
        *reinterpret_cast<float2*>(out + i) =
            make_float2(__double2float_rn(acc[2 * t]), __double2float_rn(acc[2 * t + 1]));
    }
  }
}

// Blocks [0, B): bwd_query; blocks from B: kGroups table rows each.
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chyp_train_bwd_kernel(const float* __restrict__ g, const float* __restrict__ lhs,
                      const float* __restrict__ table, const int64_t* __restrict__ ids,
                      const int* __restrict__ offsets, const float4* __restrict__ lists,
                      long long n_rows, const float* __restrict__ sr,
                      const float* __restrict__ si, const float* __restrict__ wn,
                      const float* __restrict__ x, const float* __restrict__ zn,
                      float* __restrict__ d_lhs, float* __restrict__ d_table, int B, int K,
                      int D, int cwa, int kt, float eps) {
  extern __shared__ double smem_d[];
  if ((int)blockIdx.x < B) {
    bwd_query<(V + 1) / 2>(g, lhs, table, ids, n_rows, sr, si, wn, x, zn, d_lhs, K, D, cwa,
                           kt, eps, smem_d);
    return;
  }
  const long long e = (long long)(blockIdx.x - B) * kGroups + threadIdx.x / kG;
  if (e < n_rows) bwd_row<V>((int)e, lhs, table, offsets, lists, d_table, K, D);
}

// ------------------------------- launch sizes ---------------------------------

// V: float2 a lane a chunk in the row blocks, min(8, ceil(D / 16)); the
// query blocks take (V + 1) / 2 with 16-lane groups.
int pick_v(int D) {
  const int v = (D + 2 * kG - 1) / (2 * kG);
  return v < 1 ? 1 : (v > kMaxV ? kMaxV : v);
}

// The staged column chunk: D when it fits, else equal even chunks of at
// most kMaxCols.
int pick_cw(int D) {
  const int n = (D + kMaxCols - 1) / kMaxCols;
  const int cw = (D + n - 1) / n;
  return cw + (cw & 1);
}

using BwdKernel = decltype(&chyp_train_bwd_kernel<1>);
const BwdKernel kBwd[kMaxV] = {
    chyp_train_bwd_kernel<1>, chyp_train_bwd_kernel<2>, chyp_train_bwd_kernel<3>,
    chyp_train_bwd_kernel<4>, chyp_train_bwd_kernel<5>, chyp_train_bwd_kernel<6>,
    chyp_train_bwd_kernel<7>, chyp_train_bwd_kernel<8>};

// Dynamic shared memory above the static limit needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K3's shared bytes at column chunks of cw (pitch: the staged rows'
// stride, with pitch / 2 odd so that 8-byte reads of 16 consecutive rows
// meet 32 distinct banks; nq_max: query rows a tile spans).
size_t fwd_smem(int K, int cw, int* pitch, int* nq_max) {
  const long long spans = (kTilePairs + K - 2) / K + 1;
  *nq_max = (int)(spans < kTilePairs ? spans : kTilePairs);
  *pitch = (cw / 2) % 2 ? cw : cw + 2;
  return (size_t)*nq_max * (2 * (size_t)cw + 1) * sizeof(double) +
         (size_t)kTilePairs * *pitch * sizeof(float) + (size_t)*nq_max * sizeof(float) +
         kTilePairs * sizeof(int);
}

// K4's shared bytes: the query blocks' (kt: candidates a tile).
size_t bwd_smem(int D, int cw, int* kt) {
  int t = (int)(kQueryStage / ((size_t)cw * sizeof(float)));
  t = t < kGroupsA ? kGroupsA : (t > 256 ? 256 : t);
  *kt = t;
  return (kWarps * 2 * (size_t)cw + kWarps) * sizeof(double) + 2 * (size_t)D * sizeof(float) +
         (size_t)t * (cw + 3) * sizeof(float) + (size_t)t * sizeof(int);
}

// Resident blocks of the lists kernel on the current device, at most one
// an SM (fewer blocks make each grid.sync() cheaper); cached.
int lists_grid(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chyp_train_lists_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = sms;
  }
  *blocks = cached[dev];
  return 0;
}

}  // namespace

// C interface, loaded with ctypes.  Each launcher enqueues on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take (B, K < 1, odd D, or
// shared memory beyond a block's).  Every float array is contiguous
// float32, lhs and table 8-byte aligned; ids (B, K) are int64 (NULL: the
// identity form, N == B K, pair p reads row p).  offsets (N + 1) int32
// and lists (B K records of 4 floats, 16-byte aligned) come from
// chyp_train_lists.
extern "C" int chyp_train_fwd(const float* lhs, const float* table, const int64_t* ids,
                              float* d, float* sr, float* si, float* wn, float* x, float* zn,
                              int B, int K, int D, int N, float eps, float x_min,
                              cudaStream_t stream) {
  if (B < 1 || K < 1 || D < 2 || D % 2 || N < 1) return (int)cudaErrorInvalidValue;
  // the widest even chunk up to kMaxCols whose stage fits kFwdStage
  int cw = pick_cw(D), pitch = 0, nq_max = 0;
  size_t smem = fwd_smem(K, cw, &pitch, &nq_max);
  while (smem > kFwdStage && cw > 2) smem = fwd_smem(K, cw -= 2, &pitch, &nq_max);
  const cudaError_t err = allow_smem(chyp_train_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)B * K;
  const unsigned blocks = (unsigned)((n_pairs + kTilePairs - 1) / kTilePairs);
  chyp_train_fwd_kernel<<<blocks, kTilePairs, smem, stream>>>(
      lhs, table, ids, N, d, sr, si, wn, x, zn, K, D, cw, pitch, nq_max, n_pairs, eps, x_min);
  return (int)cudaGetLastError();
}

extern "C" int chyp_train_bwd(const float* g, const float* lhs, const float* table,
                              const int64_t* ids, const int* offsets, const float* lists,
                              const float* sr, const float* si, const float* wn,
                              const float* x, const float* zn, float* d_lhs, float* d_table,
                              int B, int K, int D, int N, float eps, cudaStream_t stream) {
  if (B < 1 || K < 1 || D < 2 || D % 2 || N < 1) return (int)cudaErrorInvalidValue;
  if (ids == nullptr && (long long)N != (long long)B * K) return (int)cudaErrorInvalidValue;
  const int v = pick_v(D);
  const int cwa = pick_cw(D);
  int kt = 0;
  const size_t smem = bwd_smem(D, cwa, &kt);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kBwd[v - 1], smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)B + (unsigned)((N + kGroups - 1) / kGroups);
  kBwd[v - 1]<<<blocks, kThreads, smem, stream>>>(
      g, lhs, table, ids, offsets, reinterpret_cast<const float4*>(lists), N, sr, si, wn, x,
      zn, d_lhs, d_table, B, K, D, cwa, kt, eps);
  return (int)cudaGetLastError();
}

// K4's index preparation: offsets (N + 1) int32 and lists (P records of
// 4 floats) of the ids (P int64, NULL: the identity form) with their
// coefficients from g and the residuals (B, K) and zn (B); scratch: cursor
// (N), unsorted (P) and totals (at least chyp_train_lists_blocks) int32.
extern "C" int chyp_train_lists(const int64_t* ids, const float* g, const float* sr,
                                const float* si, const float* wn, const float* x,
                                const float* zn, int* offsets, float* lists, int* cursor,
                                int* unsorted, int* totals, int P, int N, int K,
                                int n_totals, float eps, cudaStream_t stream) {
  if (P < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = lists_grid(&blocks);
  if (err != 0) return err;
  const long long work = (long long)(P > N ? P : N);
  const long long need = (work + kThreads - 1) / kThreads;
  if (need < blocks) blocks = (int)need;
  if (blocks > n_totals) return (int)cudaErrorInvalidValue;
  float4* recs = reinterpret_cast<float4*>(lists);
  void* args[] = {(void*)&ids, (void*)&g,   (void*)&sr,      (void*)&si,     (void*)&wn,
                  (void*)&x,   (void*)&zn,  (void*)&P,       (void*)&N,      (void*)&K,
                  (void*)&eps, (void*)&offsets, (void*)&recs, (void*)&cursor,
                  (void*)&unsorted, (void*)&totals};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)chyp_train_lists_kernel,
                                                    dim3(blocks), dim3(kThreads), args, 0,
                                                    stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The resident blocks chyp_train_lists launches at most: the size its
// totals scratch needs.
extern "C" int chyp_train_lists_blocks(int* blocks) { return lists_grid(blocks); }
