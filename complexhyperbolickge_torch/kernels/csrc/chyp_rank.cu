// Filtered all-entity rank counts for the complex-hyperbolic (FFT) family,
// hand-written for Hopper (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/chyp_rank.py:
//   chyp_rank_sweep_masked  <- chyp_rank_counts        (_rank_kernel, _chyp_scores)
//   chyp_rank_sweep_nomask  <- chyp_rank_counts_nomask (_rank_kernel_nomask)
//   chyp_rank_filtered_sub  <- the filtered subtraction of chyp_rank_counts_nomask
//
// For query b and entity row j of the padded table (rows of ld >= D floats,
// of which the first D are the entity's features):
//   acc_re = sum_k lhs2[b][k]     * rhs[j][k]          (Re<z,w> + 1)
//   acc_im = sum_k lhs2[B + b][k] * rhs[j][k]          (Im<z,w>; lhs2[B+b] = swap_neg(lhs[b]))
//   x      = max(2 ((acc_re - 1)^2 + acc_im^2) / (zn[b] wn[j]) - 1, x_min)
//   score  = bt[j] - log(x + sqrt(x^2 - 1))^2
// and a query's count is #{j kept : score >= t2[b]}.  The masked sweep keeps
// j where mask[b][j] == 0; the maskless sweep keeps every j != gold[b]
// (table pad rows carry bt = -1e30, so they never reach a threshold) and
// the filtered subtraction counts the kept filtered ids, to be subtracted.
//
// Bit-identical scores across the three kernels: every kernel accumulates
// k = 0..D-1 in ascending order, one __fmaf_rn per term from 0.0f, and
// finishes with chyp_score() (epilogue.cuh), whose arithmetic is spelled
// out in round-to-nearest intrinsics so that no contraction choice of the
// compiler can differ between call sites.  wn[j] = clamp(|w_j|^2 - 1, -1, -eps) is an
// input, computed once per params version by the caller (the TPU kernel
// recomputed it per tile).  So a filtered entity that the maskless sweep
// counted is subtracted exactly, and the JAX kernel's residual +-1 on exact
// non-gold ties between two contraction shapes cannot occur.
//
// Bound on an H100 SXM at the WN18RR eval shape (B = 500, Np = 40,960,
// D = 66): 2 (2B) Np D = 5.4 GFLOP of fp32 FMA per batch, ~81 us at 67
// TFLOP/s of CUDA-core fp32 (exact fp32 rules out TF32, 3xTF32 and wgmma),
// against ~9.6 us for its 11.1 MB table (rows padded to 68 floats) plus
// 20.5 MB int8 mask at 3.35 TB/s: compute-bound, plus 20.5 M epilogues of
// one IEEE division, one square root and one logf each.
//
// The sweeps (K1 masked, K2 maskless) are one kernel template,
// chyp_sweep_kernel<masked>, on the pipeline of the real-hyperbolic sweeps
// (hyp_rank.cu, shared through sweep.cuh):
//   * whole rows: a stage holds an entity tile's rows, all D <= 68 features
//     (D = 66 at rank 33: one stage an item, two barriers, no 2-wide
//     remainder chunk), with the tile's wn and bt and, masked, its 64 x 128
//     int8 mask slice; wider D is split into equal chunks of at most 68
//     (a multiple of 4) features;
//   * the stage is copied with cp.async into one of two buffers while the
//     other buffer's contraction and epilogue run; 16-byte copies where the
//     table's row stride ld is a multiple of 4 (the ranker pads rows to 68
//     floats), 4-byte copies otherwise; the epilogue reads wn, bt and the
//     mask from shared memory; the maskless stage has no mask and keeps
//     j != gold[b];
//   * the query tile's rows (64 re rows and their 64 swapped im rows) and
//     its zn, t2 and gold are staged once per query tile (a D too wide for
//     that, above ~140: the query rows a chunk a stage);
//   * staged rows have a stride of 68 floats (17 x 16 bytes, odd): a lane's
//     float4 reads along k are conflict-free, the query values are read as
//     broadcast float4s: 12 shared loads per 128 FMAs; each thread keeps a
//     4 query x 4 entity register tile of (acc_re, acc_im) pairs (124-128
//     registers, no spills);
//   * 64 queries an item, the most that register tile allows (512 threads
//     x 124-128 registers fill an SM's register file): each entity tile is
//     staged 8 times a batch of 500, not 16 (measured on the H100: 32
//     queries of 256 threads, 2 blocks an SM, took 7 % longer; the L2 ->
//     shared copies of the restaged rows cost ~0.05 ms a batch at 32);
//   * persistent blocks: 1 of 512 threads an SM (121 KB of shared memory
//     masked), the grid the occupancy API's blocks per SM times the SMs,
//     each block a contiguous range of (query tile, entity tile) items;
//     a block adds its per-query counts with one int32 atomicAdd per query
//     and warp when its query tile changes: exact and independent of block
//     order, unlike the TPU's sequential-grid accumulator.
// What bounds them (measured on the H100 at WN18RR with 32 queries an item,
// by cutting one part at a time, PERF.md): the parts add up rather than
// overlap: the contraction ~0.12 ms (~70 % of the FMA pipe while it runs;
// shared loads at ~75 % of it), the epilogue ~0.05 ms (~0.03 of it the
// IEEE division's and square root's branch structure), and staging,
// barriers and the mask ~0.09 ms (~0.05 of it the restaged rows, which 64
// queries an item halve).  The filtered subtraction (one
// block per query over its <= L ids) keeps its schedule: it is ~1/40 of
// the sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "sweep.cuh"

namespace {

using rank_sweeps::aligned16;
using rank_sweeps::chyp_score;
using rank_sweeps::cp_async16;
using rank_sweeps::cp_async4;
using rank_sweeps::cp_async_commit;
using rank_sweeps::cp_async_wait;
using rank_sweeps::lane_of;
using rank_sweeps::mma_bf16;
using rank_sweeps::next_pos;
using rank_sweeps::StagePos;

constexpr int kTQ = 64;         // queries per block tile
constexpr int kTN = 128;        // entities per block tile
constexpr int kThreads = 512;   // 16 warps
constexpr int kQPT = 4;         // queries per thread (one warp owns 4)
constexpr int kEPT = 4;         // entities per thread (lane + 32 e)
constexpr int kChunk = 68;      // features of a staged entity row (and its stride)
constexpr int kSubThreads = 128;
constexpr int kSweepBlocks = 1;  // resident sweep blocks an SM is compiled for
constexpr int kMaxSweepSmem = 160 * 1024;  // dynamic shared memory a block may ask for
// the query tile's staged rows: 64 re rows, then their 64 im rows, of one
// chunk (staged per stage) or of all D features (once per query tile)
constexpr int kQueryChunkFloats = 2 * kTQ * kChunk;

static_assert(kThreads / 32 * kQPT == kTQ, "one warp per 4 queries");
static_assert(32 * kEPT == kTN, "one lane per 4 entities");
static_assert(kChunk % 4 == 0 && (kChunk / 4) % 2 == 1,
              "16-byte rows at an odd count of 16-byte columns: conflict-free float4 reads");

__device__ __forceinline__ void chyp_accumulate(float& acc_re, float& acc_im,
                                                float q_re, float q_im,
                                                float w) {
  acc_re = __fmaf_rn(q_re, w, acc_re);
  acc_im = __fmaf_rn(q_im, w, acc_im);
}

// ------------------------------ sweeps (K1, K2) ------------------------------

struct SweepArgs {
  const float *lhs2, *zn, *t2, *rhs, *wn, *bt;
  const int8_t* mask;  // masked sweep: 1 = not counted
  const int* gold;     // maskless sweep: the row not counted, or -1
  int* out;
  int B, Np, D, ld;    // ld: floats a table row (>= D)
  float x_min;
  int n_et, n_chunks, kc, n_items;  // entity tiles, feature chunks of kc, items
  int q_stride;       // floats a staged query row: D rounded up to 4 (whole tile)
  bool q_per_stage;   // the whole query tile does not fit: a chunk per stage
  bool vec_rows;  // ld % 4 == 0, rhs 16-byte aligned: 16-byte row copies
  bool vec_q;     // D % 4 == 0, lhs2 16-byte aligned: 16-byte query copies
  bool vec_mask;  // Np % 16 == 0, mask 16-byte aligned: 16-byte mask copies
};

// One stage of the pipeline: a feature chunk of the entity rows and, on an
// item's last chunk, the tile's wn, bt and, masked, its mask slice.  The
// query rows sit after the two stages: the tile's, all D features, copied
// once per query tile, or (a D too wide for that) one chunk per buffer.
struct StageRows {
  float w[kTN][kChunk];
  float wn[kTN], bt[kTN];
};
template <bool kMasked>
struct Stage : StageRows {};
template <>
struct Stage<true> : StageRows {
  int8_t mask[kTQ][kTN];
};
static_assert(sizeof(Stage<false>) % 16 == 0 && sizeof(Stage<true>) % 16 == 0,
              "stages stay 16-byte aligned");

int query_stride(int D) { return (D + 3) / 4 * 4; }

// Shared bytes of the query tile staged whole, and whether it fits.
template <bool kMasked>
size_t whole_query_smem(int D) {
  return 2 * sizeof(Stage<kMasked>) + sizeof(float) * 2 * kTQ * query_stride(D);
}
template <bool kMasked>
bool query_per_stage(int D) {
  return whole_query_smem<kMasked>(D) > (size_t)kMaxSweepSmem;
}

template <bool kMasked>
size_t sweep_smem(int D) {
  return query_per_stage<kMasked>(D)
             ? 2 * sizeof(Stage<kMasked>) + sizeof(float) * 2 * kQueryChunkFloats
             : whole_query_smem<kMasked>(D);
}

// A query of the tile as the epilogue reads it from shared memory.
struct TileQuery {
  float zn, t2;
  int gold;  // maskless: the row it does not count (-1: none)
  int ok;    // a query of the batch
};

// Copy features [k0, k0 + kn) of rows [r0, r0 + kRows) of a table of n rows
// of ld floats into kRows staged rows of dst_ld floats; rows past n are
// zero-filled.  One warp a row, a lane a 16-byte (vec: ld % 4 == 0, src
// 16-byte aligned) or 4-byte column.
template <int kRows>
__device__ __forceinline__ void copy_rows(float* dst, int dst_ld, const float* src, int r0, int n,
                                          int ld, int k0, int kn, bool vec, int tid) {
  const int lane = tid & 31;
  const int cols = vec ? (kn + 3) / 4 : kn;
#pragma unroll 1
  for (int r = tid >> 5; r < kRows; r += kThreads / 32) {
    const bool ok = r0 + r < n;
    const float* row = src + (size_t)(ok ? r0 + r : 0) * ld + k0;
    float* out = dst + r * dst_ld;
    for (int p = lane; p < cols; p += 32) {
      if (vec) {
        cp_async16(out + 4 * p, row + 4 * p, ok ? 16 : 0);
      } else {
        cp_async4(out + p, row + p, ok ? 4 : 0);
      }
    }
  }
}

// Copy features [k0, k0 + kn) of the query tile qt's rows, re then im, into
// q (rows of qs floats).
__device__ __forceinline__ void load_queries(const SweepArgs& a, float* q, int qs, int qt,
                                             int k0, int kn, int tid) {
  const int q0 = qt * kTQ;
  copy_rows<kTQ>(q, qs, a.lhs2, q0, a.B, a.D, k0, kn, a.vec_q, tid);
  copy_rows<kTQ>(q + kTQ * qs, qs, a.lhs2 + (size_t)a.B * a.D, q0, a.B, a.D, k0, kn, a.vec_q,
                 tid);
}

// Start the copies of the stage at `pos` into `st` (and its query chunk into
// q when the query tile is staged per stage).  Rows past B or Np are
// zero-filled; their lanes never count.
template <bool kMasked>
__device__ __forceinline__ void load_stage(const SweepArgs& a, Stage<kMasked>& st, float* q,
                                           StagePos pos, int tid) {
  const int q0 = pos.qt * kTQ, j0 = pos.et * kTN;
  const int k0 = pos.chunk * a.kc, kn = min(a.kc, a.D - k0);
  copy_rows<kTN>(&st.w[0][0], kChunk, a.rhs, j0, a.Np, a.ld, k0, kn, a.vec_rows, tid);
  if (a.q_per_stage) load_queries(a, q, kChunk, pos.qt, k0, kn, tid);
  if (pos.chunk != a.n_chunks - 1) return;
  if (tid < 2 * (kTN / 4)) {  // wn, bt: 16-byte copies, the tail zero-filled
    const int v = tid / (kTN / 4), p = tid % (kTN / 4), j = j0 + 4 * p;
    const int n = max(0, min(4, a.Np - j));
    cp_async16((v == 0 ? st.wn : st.bt) + 4 * p, (v == 0 ? a.wn : a.bt) + (n > 0 ? j : 0), 4 * n);
  }
  if constexpr (kMasked) {
    if (a.vec_mask) {
      static_assert(kTQ * (kTN / 16) == kThreads, "one 16-byte mask copy a thread");
      const int r = tid / (kTN / 16), p = tid % (kTN / 16), qq = q0 + r, j = j0 + 16 * p;
      const bool ok = qq < a.B && j < a.Np;
      cp_async16(&st.mask[r][16 * p], a.mask + (ok ? (size_t)qq * a.Np + j : 0), ok ? 16 : 0);
    } else {  // a ragged row stride: plain byte loads
#pragma unroll 1
      for (int idx = tid; idx < kTQ * kTN; idx += kThreads) {
        const int r = idx / kTN, e = idx % kTN, qq = q0 + r, j = j0 + e;
        st.mask[r][e] = (qq < a.B && j < a.Np) ? a.mask[(size_t)qq * a.Np + j] : 1;
      }
    }
  }
}

// acc += the staged chunk's first kn features, ascending: float4 reads of 4
// features at a time, then the rest one by one.  (w: the stage's rows; q:
// the query rows at the chunk's first feature, re rows then im rows, of qs
// floats.)
__device__ __forceinline__ void contract(float (&acc_re)[kQPT][kEPT],
                                         float (&acc_im)[kQPT][kEPT], const float* w,
                                         const float* q, int qs, int qbase, int lane, int kn) {
  const float* q_re = q + qbase * qs;
  const float* q_im = q + (kTQ + qbase) * qs;
  const float* w_l = w + lane * kChunk;
  int kk = 0;
#pragma unroll 1
  for (; kk + 4 <= kn; kk += 4) {
    float4 wv[kEPT];
#pragma unroll
    for (int e = 0; e < kEPT; ++e)
      wv[e] = *reinterpret_cast<const float4*>(w_l + 32 * e * kChunk + kk);
#pragma unroll
    for (int i = 0; i < kQPT; ++i) {
      const float4 qr = *reinterpret_cast<const float4*>(q_re + i * qs + kk);
      const float4 qi = *reinterpret_cast<const float4*>(q_im + i * qs + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < kEPT; ++e)
          chyp_accumulate(acc_re[i][e], acc_im[i][e], lane_of(qr, t), lane_of(qi, t),
                          lane_of(wv[e], t));
    }
  }
#pragma unroll 1
  for (; kk < kn; ++kk) {
#pragma unroll
    for (int i = 0; i < kQPT; ++i)
#pragma unroll
      for (int e = 0; e < kEPT; ++e)
        chyp_accumulate(acc_re[i][e], acc_im[i][e], q_re[i * qs + kk], q_im[i * qs + kk],
                        w_l[32 * e * kChunk + kk]);
  }
}

// K1 (kMasked) and K2's sweep.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, kSweepBlocks) chyp_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<kMasked>* st = reinterpret_cast<Stage<kMasked>*>(smem_raw);
  float* q_rows = reinterpret_cast<float*>(smem_raw + 2 * sizeof(Stage<kMasked>));
  __shared__ TileQuery tq[kTQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int qbase = (tid >> 5) * kQPT;  // this warp's first query in the tile
  int item_begin, item_end;
  rank_sweeps::block_items(a.n_items, &item_begin, &item_end);
  if (item_begin >= item_end) return;
  const int s_begin = item_begin * a.n_chunks, s_end = item_end * a.n_chunks;

  float acc_re[kQPT][kEPT], acc_im[kQPT][kEPT];
  int cnt[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    cnt[i] = 0;
#pragma unroll
    for (int e = 0; e < kEPT; ++e) acc_re[i][e] = acc_im[i][e] = 0.0f;
  }
  int cur_qt = -1;

  StagePos pos{item_begin / a.n_et, item_begin % a.n_et, 0};
  load_stage<kMasked>(a, st[0], q_rows, pos, tid);
  cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    const int chunk = pos.chunk, qt = pos.qt, j0 = pos.et * kTN;
    // a new query tile: its rows replace the last tile's, which no thread
    // reads after the previous iteration's closing barrier
    if (!a.q_per_stage && qt != cur_qt) load_queries(a, q_rows, a.q_stride, qt, 0, a.D, tid);
    cp_async_commit();
    if (s + 1 < s_end) {  // the next stage streams in while this one computes
      load_stage<kMasked>(a, st[buf ^ 1], q_rows + (buf ^ 1) * kQueryChunkFloats,
                          next_pos(pos, a.n_chunks, a.n_et), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (qt != cur_qt) {  // a new query tile: its scalars into shared memory
      cur_qt = qt;
      if (tid < kTQ) {
        const int q = qt * kTQ + tid;
        const int ok = q < a.B;
        tq[tid] = TileQuery{ok ? a.zn[q] : -1.0f, ok ? a.t2[q] : 0.0f,
                            (!kMasked && ok) ? a.gold[q] : -1, ok};
      }
    }
    __syncthreads();  // this stage's copies and the tile's queries are visible

    const Stage<kMasked>& S = st[buf];
    const int k0 = chunk * a.kc, kn = min(a.kc, a.D - k0);
    const float* q = a.q_per_stage ? q_rows + buf * kQueryChunkFloats : q_rows + k0;
    contract(acc_re, acc_im, &S.w[0][0], q, a.q_per_stage ? kChunk : a.q_stride, qbase, lane, kn);

    if (chunk == a.n_chunks - 1) {
      float zn_r[kQPT], t2_r[kQPT];
      int gold_r[kQPT];
#pragma unroll
      for (int i = 0; i < kQPT; ++i) {
        const TileQuery t = tq[qbase + i];
        zn_r[i] = t.zn;
        t2_r[i] = t.t2;
        gold_r[i] = t.gold;
      }
#pragma unroll
      for (int e = 0; e < kEPT; ++e) {
        const int el = lane + 32 * e, j = j0 + el;
        if (j < a.Np) {
          const float wn_j = S.wn[el], bt_j = S.bt[el];
#pragma unroll
          for (int i = 0; i < kQPT; ++i) {
            const float s_ij = chyp_score(acc_re[i][e], acc_im[i][e], zn_r[i], wn_j, bt_j,
                                          a.x_min);
            bool keep;
            if constexpr (kMasked) {
              keep = S.mask[qbase + i][el] == 0;
            } else {
              keep = j != gold_r[i];
            }
            cnt[i] += (keep && s_ij >= t2_r[i]) ? 1 : 0;
          }
        }
#pragma unroll
        for (int i = 0; i < kQPT; ++i) acc_re[i][e] = acc_im[i][e] = 0.0f;
      }
      const bool last_of_tile = s + 1 == s_end || next_pos(pos, a.n_chunks, a.n_et).qt != qt;
      if (last_of_tile) {
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)cnt[i]);
          if (lane == 0 && tq[qbase + i].ok && c) atomicAdd(&a.out[qt * kTQ + qbase + i], (int)c);
          cnt[i] = 0;
        }
      }
    }
    pos = next_pos(pos, a.n_chunks, a.n_et);
    __syncthreads();  // this buffer and the tile's queries are free again
  }
}

// One block per query; threads walk its L filtered ids.  Ids outside
// [0, Np) and the gold (which the maskless sweep never counted) are skipped.
__global__ void __launch_bounds__(kSubThreads)
chyp_filtered_sub_kernel(const float* __restrict__ lhs2,
                         const float* __restrict__ zn,
                         const float* __restrict__ t2,
                         const float* __restrict__ rhs,
                         const float* __restrict__ wn,
                         const float* __restrict__ bt,
                         const int* __restrict__ fidx,
                         const int* __restrict__ gold, int* __restrict__ sub,
                         int B, int Np, int D, int ld, int L, float x_min) {
  __shared__ int warp_sums[kSubThreads / 32];
  const int b = blockIdx.x;
  const float* q_re = lhs2 + (size_t)b * D;
  const float* q_im = lhs2 + (size_t)(B + b) * D;
  const float zn_b = zn[b], t2_b = t2[b];
  const int gold_b = gold[b];
  int cnt = 0;
  for (int l = threadIdx.x; l < L; l += kSubThreads) {
    const int f = fidx[(size_t)b * L + l];
    if (f < 0 || f >= Np || f == gold_b) continue;
    const float* w = rhs + (size_t)f * ld;
    float acc_re = 0.0f, acc_im = 0.0f;
    for (int k = 0; k < D; ++k) chyp_accumulate(acc_re, acc_im, q_re[k], q_im[k], w[k]);
    const float s = chyp_score(acc_re, acc_im, zn_b, wn[f], bt[f], x_min);
    cnt += (s >= t2_b) ? 1 : 0;
  }
  const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = (int)c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSubThreads / 32; ++w) total += warp_sums[w];
    sub[b] = total;
  }
}

// ---------------------------------- launchers ----------------------------------

// Resident blocks per SM of a sweep with `smem` bytes of dynamic shared
// memory on the current device, and the device's SMs.
template <bool kMasked>
int sweep_blocks_per_sm(size_t smem, int* sms) {
  static rank_sweeps::Occupancy cache;
  return rank_sweeps::blocks_per_sm(cache, chyp_sweep_kernel<kMasked>, kThreads, smem,
                                    kMaxSweepSmem, sms);
}

template <bool kMasked>
int launch_sweep(SweepArgs a, cudaStream_t stream) {
  if (a.B <= 0 || a.Np <= 0 || a.D <= 0) return 0;
  if (a.ld < a.D || !aligned16(a.wn) || !aligned16(a.bt) ||
      (kMasked ? a.mask == nullptr : a.gold == nullptr))
    return (int)cudaErrorInvalidValue;
  a.n_chunks = (a.D + kChunk - 1) / kChunk;
  a.kc = ((a.D + a.n_chunks - 1) / a.n_chunks + 3) / 4 * 4;  // <= kChunk
  a.q_stride = query_stride(a.D);
  a.q_per_stage = query_per_stage<kMasked>(a.D);
  const size_t smem = sweep_smem<kMasked>(a.D);
  int sms = 0;
  const int per_sm = sweep_blocks_per_sm<kMasked>(smem, &sms);
  if (per_sm < 0) return -per_sm;
  a.n_et = (a.Np + kTN - 1) / kTN;
  a.n_items = (a.B + kTQ - 1) / kTQ * a.n_et;
  a.vec_rows = a.ld % 4 == 0 && aligned16(a.rhs);
  a.vec_q = a.D % 4 == 0 && aligned16(a.lhs2);
  a.vec_mask = kMasked && a.Np % 16 == 0 && aligned16(a.mask);
  const int grid = rank_sweeps::grid_size(a.n_items, per_sm, sms);
  chyp_sweep_kernel<kMasked><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------- bf16 tensor-core instances (precision "default") -------------------
//
// JAX's precision="default" instance of _chyp_scores: both operands of the
// Hermitian form's contraction rounded to bf16 (the wrapper passes lhs2
// and the table as bf16 rows of D features, a multiple of 16, zero past
// the model's width), their products summed in f32 by the tensor cores
// (mma_bf16, sweep.cuh); zn, wn, bt, t2 and the epilogue stay f32.
//
// What bounds the sweep (K1, K2) on an H100 (80GB HBM3, 700 W) is not the
// contraction (6.6 GFLOP at rank 33, ~7 us of tensor-core time) nor the
// bytes (the 6.6 MB bf16 table and 20.5 MB mask, ~8 us) but the
// instructions around them: a WN18RR batch's 20.5 M pairs of one division,
// one square root and one logf each, and the staging, fragment loads,
// barriers and counts of its 5,120 items.  Scored in place from the mma
// fragments, each __fdiv_rn / __fsqrt_rn and logf's special-argument check
// would end a basic block, so a thread's pairs would run one after
// another, its accumulators live through the epilogue.  The design, on
// K5-K8 bf16's (hyp_rank.cu):
//   * persistent blocks over (query tile, entity tile) items, 64 queries x
//     64 entities an item, 8 warps, 3 resident an SM (79-80 registers, no
//     spill; 74 KB of shared memory); each stage an entity tile's rows (at
//     most kMaxChunk features of them; D = 80 at rank 33: one stage an
//     item) with its wn, bt and, masked, its 64 x 64 mask slice, copied
//     with 16-byte cp.async into one buffer while the other computes; the
//     query tile's rows staged once per query tile (a chunk per stage when
//     too wide); two barriers an item: after a stage's copies (then the
//     next stage's copies start into the buffer no thread reads any more)
//     and after the score tile's stores;
//   * warp w contracts the 16 queries of group w % 4 against the 32
//     entities of half w / 4: two A tiles, each 8 queries' re rows at rows
//     0-7 and their swapped im rows at rows 8-15, so a thread's c0, c1 are
//     acc_re and c2, c3 acc_im of one query against entities 2t and 2t + 1;
//     fragments from shared memory by ldmatrix_x4 (one instruction an A
//     tile or an n-tile pair a k-step), rows bf16_row_words() apart;
//   * after an item's k-steps each thread stores chyp_a2 of its 16 pairs
//     (the score's first step, from both accumulators) as float2s into a
//     shared f32 tile of 64 x 64 (rows padded to 72 floats: conflict-free),
//     then one barrier; no accumulator is live through the epilogue;
//   * the epilogue walks the tile entity-major: a half-warp takes a query,
//     a lane 4 consecutive entities (float4 tile, wn, bt reads; the mask's
//     4 bytes one word), 4 queries a lane; each batch of 4 pairs runs
//     chyp_x, chyp_arg, ln and chyp_end with FastArith, each step for all
//     its pairs, branch-free; after the batches one warp-uniform
//     __any_sync sends the flagged pairs through chyp_score_a2's IeeeArith
//     again.  Every rounding step is chyp_score()'s, so a score's bits are
//     chyp_score()'s (chyp_rank_scores_bf16 writes either for the proof)
//     and masked == maskless - subtraction holds exactly.
// An mma output depends only on its A row, B column and chain of k-steps
// (sweep.cuh), so each pair's a2 is the former in-place sweep's.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): K1 0.1165 -> 0.1000 ms,
// K2's sweep 0.1140 -> 0.1028, against the in-place sweep of one 512-thread
// block an SM; the parts add up: with the epilogue cut to bt + a2 the
// sweep takes 0.049 ms (0.030 of it without the k-steps: staging, barriers,
// tile and counts), the epilogue the other 0.051 (85 SASS instructions a
// pair with loads, mask, flags and count).  2 blocks an SM: 0.1053; three
// barriers an item: 0.1013; the 4-query loop rolled (2 blocks): 0.1138.
//
// The subtraction gives each filtered id the same chain: one block per
// query, a warp an n-tile of 8 of its filtered ids, the query's re row in
// A rows 0-7 and its im row in rows 8-15, the same k-steps from a zero
// accumulator, then chyp_score().  So each (query, filtered id) score
// equals the sweep's bit for bit, and K2 == K1 - subtraction holds in this
// instance too.
namespace bf16 {

using rank_sweeps::chyp_a2;
using rank_sweeps::chyp_arg;
using rank_sweeps::chyp_end;
using rank_sweeps::chyp_score_a2;
using rank_sweeps::chyp_x;
using rank_sweeps::FastArith;
using rank_sweeps::IeeeArith;
using rank_sweeps::kCounts;
using rank_sweeps::kScoresFast;
using rank_sweeps::kScoresIeee;
using rank_sweeps::ldmatrix_x4;

constexpr int kTQ = 64;         // queries per block tile: 4 groups of 16
constexpr int kTN = 64;         // entities per block tile: 8 n-tiles of 8
constexpr int kThreads = 256;   // 8 warps: query group (warp % 4) x entity half (warp / 4)
constexpr int kMT = 2;          // A tiles a warp (8 queries each)
constexpr int kNT = 4;          // n-tiles a warp (32 entities)
constexpr int kMaxChunk = 128;  // features of a staged chunk (8 k-steps)
constexpr int kMaxSmem = 200 * 1024;
constexpr int kBlocks = 3;      // resident blocks an SM the kernel is compiled for
constexpr int kQPL = 4;         // the epilogue's queries a lane: 8 w + 2 i + lane / 16
constexpr int kEPL = 4;         // its consecutive entities: 4 (lane % 16) ..
constexpr int kTileLd = kTN + 8;  // floats a score-tile row: conflict-free float2 stores
static_assert(kThreads / 32 * 2 * kQPL == kTQ && 16 * kEPL == kTN, "a half-warp a query row");
static_assert(kQPL * kEPL <= 32, "a lane's flags fit one word");
static_assert(kTQ * (kTN / 16) == kThreads, "one 16-byte mask copy a thread");

struct Args {
  const uint32_t* lhs2;  // (2B, D) bf16, two features a word
  const float *zn, *t2;
  const uint32_t* rhs;   // (Np, ld) bf16
  const float *wn, *bt;
  const int8_t* mask;
  const int* gold;
  int* out;
  int B, Np, D, ld;  // D, ld in bf16 features
  float x_min;
  int n_et, n_chunks, kc, n_items;
  int ws;            // words a staged entity row (and per-stage query row)
  int qs;            // words a staged query row of the whole tile
  bool q_per_stage;  // the whole query tile does not fit: a chunk per stage
  bool vec_mask;
  int off_wn, off_bt, off_mask, off_q, stage_bytes;  // a stage's layout, bytes
  int off_tile;      // the score tile's byte offset
  float* scores;     // kOut != kCounts: (B, Np) scores in place of counts
  int* n_flagged;    // kScoresFast: adds the pairs the fast path flagged
};

// The launch geometry on D features (D % 16 == 0) and the shared bytes.
// One stage: w[kTN][ws] words, wn[kTN], bt[kTN], masked mask[kTQ][kTN],
// per-stage queries q[2 kTQ][ws] words (re rows, then im rows); after two
// stages the whole query tile's rows (2 kTQ x qs words) unless per stage,
// then the score tile, [kTQ][kTileLd] floats.
template <bool kMasked>
size_t plan(Args& a) {
  a.n_chunks = (a.D + kMaxChunk - 1) / kMaxChunk;
  a.kc = ((a.D + a.n_chunks - 1) / a.n_chunks + 15) / 16 * 16;  // <= kMaxChunk
  a.ws = rank_sweeps::bf16_row_words(a.kc);
  a.qs = rank_sweeps::bf16_row_words(a.D);
  size_t smem = 0;
  for (int per_stage = 0; per_stage < 2; ++per_stage) {
    a.q_per_stage = per_stage;
    a.off_wn = kTN * a.ws * 4;
    a.off_bt = a.off_wn + kTN * 4;
    a.off_mask = a.off_bt + kTN * 4;
    a.off_q = a.off_mask + (kMasked ? kTQ * kTN : 0);
    a.stage_bytes = a.off_q + (a.q_per_stage ? 2 * kTQ * a.ws * 4 : 0);
    a.off_tile = 2 * a.stage_bytes + (a.q_per_stage ? 0 : 2 * kTQ * a.qs * 4);
    smem = (size_t)a.off_tile + kTQ * kTileLd * 4;
    if (smem <= (size_t)kMaxSmem) break;
  }
  return smem;
}

// The query tile qt's rows, words [w0, w0 + nw), re rows then im rows, into
// q (rows of qs words).
__device__ __forceinline__ void load_queries(const Args& a, uint32_t* q, int qs, int qt, int w0,
                                             int nw, int tid) {
  const int ld = a.ld / 2, q0 = qt * kTQ;
  rank_sweeps::copy_words<kTQ, kThreads>(q, qs, a.lhs2, q0, a.B, ld, w0, nw, tid);
  rank_sweeps::copy_words<kTQ, kThreads>(q + kTQ * qs, qs, a.lhs2 + (size_t)a.B * ld, q0, a.B,
                                         ld, w0, nw, tid);
}

template <bool kMasked>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st, StagePos pos,
                                           int tid) {
  const int q0 = pos.qt * kTQ, j0 = pos.et * kTN;
  const int k0 = pos.chunk * a.kc, kn = min(a.kc, a.D - k0);
  rank_sweeps::copy_words<kTN, kThreads>(reinterpret_cast<uint32_t*>(st), a.ws, a.rhs, j0, a.Np,
                                         a.ld / 2, k0 / 2, kn / 2, tid);
  if (a.q_per_stage)
    load_queries(a, reinterpret_cast<uint32_t*>(st + a.off_q), a.ws, pos.qt, k0 / 2, kn / 2, tid);
  if (pos.chunk != a.n_chunks - 1) return;
  if (tid < 2 * (kTN / 4)) {  // wn, bt: 16-byte copies, the tail zero-filled
    const int v = tid / (kTN / 4), p = tid % (kTN / 4), j = j0 + 4 * p;
    const int n = max(0, min(4, a.Np - j));
    float* dst = reinterpret_cast<float*>(st + (v == 0 ? a.off_wn : a.off_bt));
    cp_async16(dst + 4 * p, (v == 0 ? a.wn : a.bt) + (n > 0 ? j : 0), 4 * n);
  }
  if constexpr (kMasked) {
    int8_t* mask = reinterpret_cast<int8_t*>(st + a.off_mask);
    if (a.vec_mask) {
      const int r = tid / (kTN / 16), p = tid % (kTN / 16), qq = q0 + r, j = j0 + 16 * p;
      const bool ok = qq < a.B && j < a.Np;
      cp_async16(mask + r * kTN + 16 * p, a.mask + (ok ? (size_t)qq * a.Np + j : 0), ok ? 16 : 0);
    } else {  // a ragged row stride: plain byte loads
#pragma unroll 1
      for (int idx = tid; idx < kTQ * kTN; idx += kThreads) {
        const int r = idx / kTN, e = idx % kTN, qq = q0 + r, j = j0 + e;
        mask[r * kTN + e] = (qq < a.B && j < a.Np) ? a.mask[(size_t)qq * a.Np + j] : 1;
      }
    }
  }
}

// An item's epilogue: queries q0, q0 + 2, q0 + 4, q0 + 6 of the tile (q0 =
// 8 warp + lane / 16) against the lane's entities el .. el + 3, one query
// a batch, each step of the score for the batch's 4 pairs before the next;
// counts into cnt (kCounts) or writes the scores.  A pair whose FastArith
// flag is set (bit i kEPL + e of `flagged`) is left out and scored again
// after the batches through IeeeArith, one rolled loop a thread, when a
// lane of the warp has one.
template <bool kMasked, int kOut>
__device__ __forceinline__ void tile_epilogue(const Args& a, const unsigned char* st,
                                              const float* tile, const TileQuery* tq, int qt,
                                              int j0, int q0, int el, int (&cnt)[kQPL]) {
  const float* s_wn = reinterpret_cast<const float*>(st + a.off_wn);
  const float* s_bt = reinterpret_cast<const float*>(st + a.off_bt);
  const int8_t* s_mask = reinterpret_cast<const int8_t*>(st + a.off_mask);
  const float4 wnv = *reinterpret_cast<const float4*>(s_wn + el);
  const float4 btv = *reinterpret_cast<const float4*>(s_bt + el);
  bool valid[kEPL];  // rows of the table
#pragma unroll
  for (int e = 0; e < kEPL; ++e) valid[e] = j0 + el + e < a.Np;
  unsigned flagged = 0;
#pragma unroll
  for (int i = 0; i < kQPL; ++i) {
    const int ql = q0 + 2 * i;
    const TileQuery tt = tq[ql];
    const float4 a2 = *reinterpret_cast<const float4*>(tile + ql * kTileLd + el);
    float s[kEPL];
    if constexpr (kOut == kScoresIeee) {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) {
        IeeeArith ar;
        s[e] = chyp_score_a2(lane_of(a2, e), tt.zn, lane_of(wnv, e), lane_of(btv, e), a.x_min, ar);
      }
    } else {
      FastArith ar[kEPL];
      float v[kEPL];
#pragma unroll
      for (int e = 0; e < kEPL; ++e)
        v[e] = chyp_x(lane_of(a2, e), tt.zn, lane_of(wnv, e), a.x_min, ar[e]);
#pragma unroll
      for (int e = 0; e < kEPL; ++e) v[e] = chyp_arg(v[e], ar[e]);
#pragma unroll
      for (int e = 0; e < kEPL; ++e) v[e] = ar[e].ln(v[e]);
#pragma unroll
      for (int e = 0; e < kEPL; ++e) {
        s[e] = chyp_end(v[e], lane_of(btv, e));
        if (ar[e].bad && valid[e] && tt.ok) flagged |= 1u << (i * kEPL + e);
      }
    }
    uint32_t mw = 0;  // the pairs' mask bytes
    if constexpr (kOut == kCounts && kMasked)
      mw = *reinterpret_cast<const uint32_t*>(s_mask + ql * kTN + el);
    int hits = 0;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) {
      const bool ok = valid[e] && !((flagged >> (i * kEPL + e)) & 1u);
      if constexpr (kOut == kCounts) {
        const bool keep = kMasked ? ((mw >> (8 * e)) & 0xffu) == 0 : j0 + el + e != tt.gold;
        hits += (ok && keep && s[e] >= tt.t2) ? 1 : 0;
      } else if (ok && tt.ok) {
        a.scores[(size_t)(qt * kTQ + ql) * a.Np + j0 + el + e] = s[e];
      }
    }
    cnt[i] += hits;
  }
  // the flagged pairs again, through __fdiv_rn / __fsqrt_rn / logf
  if (kOut != kScoresIeee && __any_sync(0xffffffffu, flagged != 0)) {
#pragma unroll 1
    for (unsigned f = flagged; f; f &= f - 1) {
      const int p = __ffs(f) - 1, i = p / kEPL, e = el + p % kEPL;
      const int ql = q0 + 2 * i, j = j0 + e;
      const TileQuery tt = tq[ql];
      IeeeArith ar;
      const float sc = chyp_score_a2(tile[ql * kTileLd + e], tt.zn, s_wn[e], s_bt[e], a.x_min, ar);
      if constexpr (kOut == kCounts) {
        const bool keep = kMasked ? s_mask[ql * kTN + e] == 0 : j != tt.gold;
        const int hit = (keep && sc >= tt.t2) ? 1 : 0;
#pragma unroll
        for (int k = 0; k < kQPL; ++k) cnt[k] += k == i ? hit : 0;  // cnt stays in registers
      } else {
        a.scores[(size_t)(qt * kTQ + ql) * a.Np + j] = sc;
      }
    }
  }
  if constexpr (kOut == kScoresFast) {
    const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)__popc(flagged));
    if ((threadIdx.x & 31) == 0 && c && a.n_flagged) atomicAdd(a.n_flagged, (int)c);
  }
}

// K1 (kMasked) and K2's sweep, bf16 instance; kOut != kCounts: the scores.
// An item's accumulators live only through its chunks' k-steps and the
// store of their a2 to the score tile.
template <bool kMasked, int kOut>
__global__ void __launch_bounds__(kThreads, kBlocks) chyp_sweep_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ TileQuery tq[kTQ];
  uint32_t* q_whole = reinterpret_cast<uint32_t*>(smem_raw + 2 * a.stage_bytes);
  float* tile = reinterpret_cast<float*>(smem_raw + a.off_tile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = (warp & 3) * (kMT * 8);   // this warp's first query in the tile
  const int e_base = (warp >> 2) * (kNT * 8);  // this warp's first entity in the tile
  // ldmatrix_x4's rows: lane l gives row l % 8 of matrix l / 8; an A tile's
  // matrices are re (k 0-7), im (k 0-7), re (k 8-15), im (k 8-15), an
  // n-tile pair's (2p, k 0-7), (2p, k 8-15), (2p + 1, k 0-7), (2p + 1, k 8-15)
  const int a_row = ((lane >> 3) & 1) * kTQ + m_base + (lane & 7), a_word = 4 * (lane >> 4);
  const int b_row = e_base + (lane >> 4) * 8 + (lane & 7), b_word = 4 * ((lane >> 3) & 1);
  const int q0 = 8 * warp + (lane >> 4), el = kEPL * (lane & 15);  // the epilogue's
  int item_begin, item_end;
  rank_sweeps::block_items(a.n_items, &item_begin, &item_end);
  if (item_begin >= item_end) return;
  const int s_begin = item_begin * a.n_chunks, s_end = item_end * a.n_chunks;

  int cnt[kQPL];
#pragma unroll
  for (int i = 0; i < kQPL; ++i) cnt[i] = 0;
  int cur_qt = -1;

  StagePos pos{item_begin / a.n_et, item_begin % a.n_et, 0};
  load_stage<kMasked>(a, smem_raw, pos, tid);
  cp_async_commit();
  for (int s = s_begin; s < s_end;) {  // an item a trip
    const int qt = pos.qt, j0 = pos.et * kTN;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
    const unsigned char* st = smem_raw;
    for (int chunk = 0; chunk < a.n_chunks; ++chunk, ++s) {
      const int buf = (s - s_begin) & 1;
      st = smem_raw + buf * a.stage_bytes;
      // a new query tile: its rows replace the last tile's, whose k-steps
      // every thread finished before the last item's tile barrier
      if (!a.q_per_stage && qt != cur_qt) {
        load_queries(a, q_whole, a.qs, qt, 0, a.D / 2, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();  // this stage, issued a stage ago, and the query rows
      __syncthreads();  // ... are visible, and no thread reads the other buffer any more
      if (s + 1 < s_end) {  // the next stage streams into it while this one computes
        load_stage<kMasked>(a, smem_raw + (buf ^ 1) * a.stage_bytes,
                            next_pos(pos, a.n_chunks, a.n_et), tid);
        cp_async_commit();
      }
      if (qt != cur_qt) {  // a new query tile: its scalars, read after the tile barrier
        cur_qt = qt;
        if (tid < kTQ) {
          const int q = qt * kTQ + tid;
          const int ok = q < a.B;
          tq[tid] = TileQuery{ok ? a.zn[q] : -1.0f, (kOut == kCounts && ok) ? a.t2[q] : 0.0f,
                              (!kMasked && kOut == kCounts && ok) ? a.gold[q] : -1, ok};
        }
      }

      const int k0 = chunk * a.kc, kn = min(a.kc, a.D - k0);
      const uint32_t* q = a.q_per_stage ? reinterpret_cast<const uint32_t*>(st + a.off_q)
                                        : q_whole + k0 / 2;
      const int qs = a.q_per_stage ? a.ws : a.qs;
      const uint32_t* qa = q + a_row * qs + a_word;
      const uint32_t* wb = reinterpret_cast<const uint32_t*>(st) + b_row * a.ws + b_word;
#pragma unroll 1
      for (int kw = 0; kw < kn / 2; kw += 8) {  // one k-step of 16 features
        uint32_t af[kMT][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m) ldmatrix_x4(af[m], qa + 8 * m * qs + kw);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, wb + 16 * p * a.ws + kw);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(acc[m][2 * p], af[m][0], af[m][1], af[m][2], af[m][3], bf[0], bf[1]);
            mma_bf16(acc[m][2 * p + 1], af[m][0], af[m][1], af[m][2], af[m][3], bf[2], bf[3]);
          }
        }
      }
      pos = next_pos(pos, a.n_chunks, a.n_et);
    }

    // a2 of the fragments' pairs into the score tile: (query g, entities
    // 2t, 2t + 1) of each A tile and n-tile, from c0, c1 (re) and c2, c3 (im)
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int row = m_base + 8 * m + g, col = e_base + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(tile + row * kTileLd + col) =
            make_float2(chyp_a2(acc[m][n][0], acc[m][n][2]), chyp_a2(acc[m][n][1], acc[m][n][3]));
      }
    __syncthreads();  // the tile is whole
    tile_epilogue<kMasked, kOut>(a, st, tile, tq, qt, j0, q0, el, cnt);
    if (kOut == kCounts && (s == s_end || pos.qt != qt)) {  // the tile's last item
#pragma unroll
      for (int i = 0; i < kQPL; ++i) {  // a half-warp's 16 lanes hold a query's counts
        int c = cnt[i];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
        const int ql = q0 + 2 * i;
        if ((lane & 15) == 0 && tq[ql].ok && c) atomicAdd(&a.out[qt * kTQ + ql], c);
        cnt[i] = 0;
      }
    }
  }
}

// One block per query; a warp takes 8 of its filtered ids at a time as the
// 8 columns of one mma chain.  Ids outside [0, Np) and the gold are skipped.
__global__ void __launch_bounds__(kSubThreads)
chyp_filtered_sub_bf16_kernel(const uint32_t* __restrict__ lhs2, const float* __restrict__ zn,
                              const float* __restrict__ t2, const uint32_t* __restrict__ rhs,
                              const float* __restrict__ wn, const float* __restrict__ bt,
                              const int* __restrict__ fidx, const int* __restrict__ gold,
                              int* __restrict__ sub, int B, int Np, int D, int ld, int L,
                              float x_min) {
  __shared__ int warp_sums[kSubThreads / 32];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* q_re = lhs2 + (size_t)b * (ld / 2) + t;
  const uint32_t* q_im = lhs2 + (size_t)(B + b) * (ld / 2) + t;
  const float zn_b = zn[b], t2_b = t2[b];
  const int gold_b = gold[b];
  const int* f_b = fidx + (size_t)b * L;
  int cnt = 0;
#pragma unroll 1
  for (int l0 = warp * 8; l0 < L; l0 += kSubThreads / 32 * 8) {
    const int fg = l0 + g < L ? f_b[l0 + g] : -1;  // this lane's column: id l0 + g
    const bool ok_g = fg >= 0 && fg < Np;
    const uint32_t* w = rhs + (size_t)(ok_g ? fg : 0) * (ld / 2) + t;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int kw = 0; kw < D / 2; kw += 8)
      mma_bf16(acc, q_re[kw], q_im[kw], q_re[kw + 4], q_im[kw + 4], ok_g ? w[kw] : 0u,
               ok_g ? w[kw + 4] : 0u);
    if (g == 0) {  // row 0 (re) and row 8 (im) of columns 2t, 2t + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + 2 * t + h;
        const int f = l < L ? f_b[l] : -1;
        if (f >= 0 && f < Np && f != gold_b) {
          const float s = chyp_score(acc[h], acc[2 + h], zn_b, wn[f], bt[f], x_min);
          cnt += (s >= t2_b) ? 1 : 0;
        }
      }
    }
  }
  const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)cnt);
  if (lane == 0) warp_sums[warp] = (int)c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kSubThreads / 32; ++i) total += warp_sums[i];
    sub[b] = total;
  }
}


template <bool kMasked, int kOut>
int blocks_per_sm(size_t smem, int* sms) {
  static rank_sweeps::Occupancy cache;
  return rank_sweeps::blocks_per_sm(cache, chyp_sweep_bf16_kernel<kMasked, kOut>, kThreads, smem,
                                    kMaxSmem, sms);
}

template <bool kMasked, int kOut>
int launch_sweep(Args a, cudaStream_t stream) {
  if (a.B <= 0 || a.Np <= 0 || a.D <= 0) return 0;
  if (a.D % 16 || a.ld < a.D || a.ld % 8 || !aligned16(a.lhs2) || !aligned16(a.rhs) ||
      !aligned16(a.wn) || !aligned16(a.bt) ||
      (kOut != kCounts ? a.scores == nullptr : (kMasked ? a.mask == nullptr : a.gold == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = plan<kMasked>(a);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int per_sm = blocks_per_sm<kMasked, kOut>(smem, &sms);
  if (per_sm < 0) return -per_sm;
  a.n_et = (a.Np + kTN - 1) / kTN;
  a.n_items = (a.B + kTQ - 1) / kTQ * a.n_et;
  a.vec_mask = kMasked && a.Np % 16 == 0 && aligned16(a.mask);
  const int grid = rank_sweeps::grid_size(a.n_items, per_sm, sms);
  chyp_sweep_bf16_kernel<kMasked, kOut><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int info(int D, int* regs, int* local_bytes, int* per_sm_out, int* smem_out) {
  Args a{};
  a.D = D;
  const size_t smem = plan<kMasked>(a);
  int sms = 0;
  const int per_sm = blocks_per_sm<kMasked, kCounts>(smem, &sms);
  if (per_sm < 0) return -per_sm;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, chyp_sweep_bf16_kernel<kMasked, kCounts>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *per_sm_out = per_sm;
  *smem_out = (int)(smem + attr.sharedSizeBytes);
  return 0;
}

// Args of a bf16 sweep from the C interface's arguments.
Args from(const void* lhs2, const float* zn, const float* t2, const void* rhs, const float* wn,
          const float* bt, int B, int Np, int D, int ld, float x_min) {
  Args a{};
  a.lhs2 = static_cast<const uint32_t*>(lhs2);
  a.zn = zn, a.t2 = t2, a.rhs = static_cast<const uint32_t*>(rhs), a.wn = wn, a.bt = bt;
  a.B = B, a.Np = Np, a.D = D, a.ld = ld, a.x_min = x_min;
  return a;
}

}  // namespace bf16

}  // namespace

// C interface, loaded with ctypes.  Each launcher enqueues on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// `counts` must be zeroed by the caller.  rhs is (Np, ld) with ld >= D, its
// first D columns the features; wn and bt 16-byte aligned.
extern "C" int chyp_rank_sweep_masked(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int8_t* mask, int* counts, int B,
                                      int Np, int D, int ld, float x_min,
                                      cudaStream_t stream) {
  const SweepArgs a{lhs2, zn, t2, rhs, wn, bt, mask, nullptr, counts, B, Np, D, ld, x_min};
  return launch_sweep<true>(a, stream);
}

extern "C" int chyp_rank_sweep_nomask(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int* gold, int* counts, int B,
                                      int Np, int D, int ld, float x_min,
                                      cudaStream_t stream) {
  const SweepArgs a{lhs2, zn, t2, rhs, wn, bt, nullptr, gold, counts, B, Np, D, ld, x_min};
  return launch_sweep<false>(a, stream);
}

extern "C" int chyp_rank_filtered_sub(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int* fidx, const int* gold,
                                      int* sub, int B, int Np, int D, int ld, int L,
                                      float x_min, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (ld < D) return (int)cudaErrorInvalidValue;
  chyp_filtered_sub_kernel<<<B, kSubThreads, 0, stream>>>(
      lhs2, zn, t2, rhs, wn, bt, fidx, gold, sub, B, Np, D, ld, L, x_min);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread, resident blocks per SM
// and shared bytes a block of the masked or maskless sweep at feature width
// D on the current device.
extern "C" int chyp_rank_sweep_info(int masked, int D, int* regs, int* local_bytes,
                                    int* blocks_per_sm, int* smem_bytes) {
  auto info = [&](auto kernel, size_t smem, int per_sm) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *blocks_per_sm = per_sm;
    *smem_bytes = (int)(smem + attr.sharedSizeBytes);
    return 0;
  };
  if (D <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (masked) {
    const size_t smem = sweep_smem<true>(D);
    const int per_sm = sweep_blocks_per_sm<true>(smem, &sms);
    return per_sm < 0 ? -per_sm : info(chyp_sweep_kernel<true>, smem, per_sm);
  }
  const size_t smem = sweep_smem<false>(D);
  const int per_sm = sweep_blocks_per_sm<false>(smem, &sms);
  return per_sm < 0 ? -per_sm : info(chyp_sweep_kernel<false>, smem, per_sm);
}

// The bf16 instances (precision "default"): the same arguments, lhs2 and
// rhs bf16 rows (ld = D features, a multiple of 16, 16-byte aligned).
extern "C" int chyp_rank_sweep_masked_bf16(const void* lhs2, const float* zn, const float* t2,
                                           const void* rhs, const float* wn, const float* bt,
                                           const int8_t* mask, int* counts, int B, int Np,
                                           int D, int ld, float x_min, cudaStream_t stream) {
  bf16::Args a = bf16::from(lhs2, zn, t2, rhs, wn, bt, B, Np, D, ld, x_min);
  a.mask = mask, a.out = counts;
  return bf16::launch_sweep<true, bf16::kCounts>(a, stream);
}

extern "C" int chyp_rank_sweep_nomask_bf16(const void* lhs2, const float* zn, const float* t2,
                                           const void* rhs, const float* wn, const float* bt,
                                           const int* gold, int* counts, int B, int Np, int D,
                                           int ld, float x_min, cudaStream_t stream) {
  bf16::Args a = bf16::from(lhs2, zn, t2, rhs, wn, bt, B, Np, D, ld, x_min);
  a.gold = gold, a.out = counts;
  return bf16::launch_sweep<false, bf16::kCounts>(a, stream);
}

extern "C" int chyp_rank_filtered_sub_bf16(const void* lhs2, const float* zn, const float* t2,
                                           const void* rhs, const float* wn, const float* bt,
                                           const int* fidx, const int* gold, int* sub, int B,
                                           int Np, int D, int ld, int L, float x_min,
                                           cudaStream_t stream) {
  if (B <= 0) return 0;
  if (D % 16 || ld < D || ld % 2) return (int)cudaErrorInvalidValue;
  bf16::chyp_filtered_sub_bf16_kernel<<<B, kSubThreads, 0, stream>>>(
      static_cast<const uint32_t*>(lhs2), zn, t2, static_cast<const uint32_t*>(rhs), wn, bt, fidx,
      gold, sub, B, Np, D, ld, L, x_min);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread, resident blocks per SM
// and shared bytes a block of the bf16 sweep at D bf16 features.
extern "C" int chyp_rank_sweep_bf16_info(int masked, int D, int* regs, int* local_bytes,
                                         int* blocks_per_sm, int* smem_bytes) {
  if (D <= 0 || D % 16) return (int)cudaErrorInvalidValue;
  return masked ? bf16::info<true>(D, regs, local_bytes, blocks_per_sm, smem_bytes)
                : bf16::info<false>(D, regs, local_bytes, blocks_per_sm, smem_bytes);
}

// The bf16 maskless sweep writing every pair's score (B, Np) float32 in
// place of counts, through the batched epilogue (ieee 0; *flagged, zeroed
// by the caller, gains the pairs its fast path flagged) or through
// chyp_score()'s __fdiv_rn / __fsqrt_rn / logf on the same score tile
// (ieee 1): the proof that both give the same bits.  The arguments of the
// bf16 sweeps with no t2, mask or gold.
extern "C" int chyp_rank_scores_bf16(const void* lhs2, const float* zn, const void* rhs,
                                     const float* wn, const float* bt, float* scores,
                                     int* flagged, int B, int Np, int D, int ld, float x_min,
                                     int ieee, cudaStream_t stream) {
  bf16::Args a = bf16::from(lhs2, zn, nullptr, rhs, wn, bt, B, Np, D, ld, x_min);
  a.scores = scores, a.n_flagged = flagged;
  return ieee ? bf16::launch_sweep<false, bf16::kScoresIeee>(a, stream)
              : bf16::launch_sweep<false, bf16::kScoresFast>(a, stream);
}
