// Filtered all-entity rank counts for the complex-hyperbolic (FFT) family,
// hand-written for Hopper (sm_90a).
//
// Replaces complexhyperbolickge_tpu/kernels/chyp_rank.py:
//   chyp_rank_sweep_masked  <- chyp_rank_counts        (_rank_kernel, _chyp_scores)
//   chyp_rank_sweep_nomask  <- chyp_rank_counts_nomask (_rank_kernel_nomask)
//   chyp_rank_filtered_sub  <- the filtered subtraction of chyp_rank_counts_nomask
//
// For query b and entity row j of the padded table:
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
// finishes with chyp_score(), whose arithmetic is spelled out in
// round-to-nearest intrinsics so that no contraction choice of the compiler
// can differ between call sites.  wn[j] = clamp(|w_j|^2 - 1, -1, -eps) is an
// input, computed once per params version by the caller (the TPU kernel
// recomputed it per tile).  So a filtered entity that the maskless sweep
// counted is subtracted exactly, and the JAX kernel's residual +-1 on exact
// non-gold ties between two contraction shapes cannot occur.
//
// Bound on an H100 SXM at the WN18RR eval shape (B=500, N=40,943, D=66):
// 2 (2B) N D = 5.4 GFLOP of fp32 FMA per batch, ~81 us at 67 TFLOP/s of
// CUDA-core fp32 (exact fp32 rules out TF32 and wgmma has no fp32 input),
// against ~9.4 us for its 10.8 MB table plus 20.7 MB int8 mask at
// 3.35 TB/s: compute-bound, plus 20.5 M log/sqrt/div epilogues.
// Design: 256-thread blocks take a 32-query x 128-entity tile; features are
// staged through shared memory in chunks of 32; each thread keeps a 4 x 4
// register tile of (acc_re, acc_im) pairs, reads its 4 queries' values as
// one broadcast float4 and its 4 entities' values conflict-free (row stride
// 33).  A block walks 8 entity tiles (grid = entity chunks x query tiles,
// 40 x 16 blocks at the eval shape, so B = 500 still fills 132 SMs) and adds
// its per-query counts with one int32 atomicAdd per query and warp: exact
// and independent of block order, unlike the TPU's sequential-grid
// accumulator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 32;            // queries per block tile
constexpr int kTN = 128;           // entities per block tile
constexpr int kKC = 32;            // features staged per chunk
constexpr int kThreads = 256;      // 8 warps
constexpr int kQPT = 4;            // queries per thread (one warp owns 4)
constexpr int kEPT = 4;            // entities per thread (lane + 32 e)
constexpr int kTilesPerBlock = 8;  // entity tiles walked by one block
constexpr int kQStride = kTQ + 4;  // float4-aligned, fewer store conflicts
constexpr int kSubThreads = 128;

static_assert(kThreads / 32 * kQPT == kTQ, "one warp per 4 queries");
static_assert(32 * kEPT == kTN, "one lane per 4 entities");

__device__ __forceinline__ void chyp_accumulate(float& acc_re, float& acc_im,
                                                float q_re, float q_im,
                                                float w) {
  acc_re = __fmaf_rn(q_re, w, acc_re);
  acc_im = __fmaf_rn(q_im, w, acc_im);
}

// The score epilogue shared by all kernels (the JAX _chyp_scores epilogue).
// acosh is taken as log(x + sqrt(x^2 - 1)) as in the TPU kernel and the
// plain version, not acoshf, which differs by ulps.  The clamp keeps NaN
// (as jnp.maximum does; fmaxf would drop it).
__device__ __forceinline__ float chyp_score(float acc_re, float acc_im,
                                            float zn, float wn, float bt,
                                            float x_min) {
  const float sr = __fsub_rn(acc_re, 1.0f);
  const float a2 = __fadd_rn(__fmul_rn(sr, sr), __fmul_rn(acc_im, acc_im));
  float x = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, a2), __fmul_rn(zn, wn)), 1.0f);
  x = (x < x_min) ? x_min : x;
  const float d = logf(__fadd_rn(x, __fsqrt_rn(__fsub_rn(__fmul_rn(x, x), 1.0f))));
  return __fsub_rn(bt, __fmul_rn(d, d));
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
chyp_sweep_kernel(const float* __restrict__ lhs2, const float* __restrict__ zn,
                  const float* __restrict__ t2, const float* __restrict__ rhs,
                  const float* __restrict__ wn, const float* __restrict__ bt,
                  const int8_t* __restrict__ mask, const int* __restrict__ gold,
                  int* __restrict__ counts, int B, int Np, int D, float x_min) {
  __shared__ __align__(16) float q_re[kKC][kQStride];
  __shared__ __align__(16) float q_im[kKC][kQStride];
  __shared__ float w_s[kTN][kKC + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int qbase = (tid >> 5) * kQPT;  // this warp's first query in the tile
  const int q0 = blockIdx.y * kTQ;

  float zn_r[kQPT], t2_r[kQPT];
  int gold_r[kQPT], cnt[kQPT];
  bool q_ok[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int q = q0 + qbase + i;
    q_ok[i] = q < B;
    zn_r[i] = q_ok[i] ? zn[q] : -1.0f;
    t2_r[i] = q_ok[i] ? t2[q] : 0.0f;
    gold_r[i] = (!kMasked && q_ok[i]) ? gold[q] : -1;
    cnt[i] = 0;
  }

  const int n_tiles = (Np + kTN - 1) / kTN;
  const int tile_end = min(n_tiles, (blockIdx.x + 1) * kTilesPerBlock);
  for (int tile = blockIdx.x * kTilesPerBlock; tile < tile_end; ++tile) {
    const int j0 = tile * kTN;
    float acc_re[kQPT][kEPT], acc_im[kQPT][kEPT];
#pragma unroll
    for (int i = 0; i < kQPT; ++i)
#pragma unroll
      for (int e = 0; e < kEPT; ++e) acc_re[i][e] = acc_im[i][e] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += kKC) {
      const int kn = min(kKC, D - k0);
      __syncthreads();  // the previous chunk's reads are done
      for (int idx = tid; idx < kTQ * kKC; idx += kThreads) {
        const int qq = idx / kKC, kk = idx % kKC, q = q0 + qq;
        const bool ok = q < B && kk < kn;
        q_re[kk][qq] = ok ? lhs2[(size_t)q * D + k0 + kk] : 0.0f;
        q_im[kk][qq] = ok ? lhs2[(size_t)(B + q) * D + k0 + kk] : 0.0f;
      }
      for (int idx = tid; idx < kTN * kKC; idx += kThreads) {
        const int e = idx / kKC, kk = idx % kKC, j = j0 + e;
        w_s[e][kk] = (j < Np && kk < kn) ? rhs[(size_t)j * D + k0 + kk] : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        const float4 qr = *reinterpret_cast<const float4*>(&q_re[kk][qbase]);
        const float4 qi = *reinterpret_cast<const float4*>(&q_im[kk][qbase]);
        const float qre[kQPT] = {qr.x, qr.y, qr.z, qr.w};
        const float qim[kQPT] = {qi.x, qi.y, qi.z, qi.w};
#pragma unroll
        for (int e = 0; e < kEPT; ++e) {
          const float w = w_s[lane + 32 * e][kk];
#pragma unroll
          for (int i = 0; i < kQPT; ++i)
            chyp_accumulate(acc_re[i][e], acc_im[i][e], qre[i], qim[i], w);
        }
      }
    }

#pragma unroll
    for (int e = 0; e < kEPT; ++e) {
      const int j = j0 + lane + 32 * e;
      if (j >= Np) continue;
      const float wn_j = wn[j], bt_j = bt[j];
#pragma unroll
      for (int i = 0; i < kQPT; ++i) {
        if (!q_ok[i]) continue;
        const float s = chyp_score(acc_re[i][e], acc_im[i][e], zn_r[i], wn_j,
                                   bt_j, x_min);
        bool keep;
        if (kMasked) {
          keep = mask[(size_t)(q0 + qbase + i) * Np + j] == 0;
        } else {
          keep = j != gold_r[i];
        }
        cnt[i] += (keep && s >= t2_r[i]) ? 1 : 0;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)cnt[i]);
    if (lane == 0 && q_ok[i] && c) atomicAdd(&counts[q0 + qbase + i], (int)c);
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
                         int B, int Np, int D, int L, float x_min) {
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
    const float* w = rhs + (size_t)f * D;
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

dim3 sweep_grid(int B, int Np) {
  const int n_tiles = (Np + kTN - 1) / kTN;
  return dim3((n_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
              (B + kTQ - 1) / kTQ);
}

}  // namespace

// C interface, loaded with ctypes.  Each launcher enqueues on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// `counts` must be zeroed by the caller.
extern "C" int chyp_rank_sweep_masked(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int8_t* mask, int* counts, int B,
                                      int Np, int D, float x_min,
                                      cudaStream_t stream) {
  if (B <= 0 || Np <= 0) return 0;
  chyp_sweep_kernel<true><<<sweep_grid(B, Np), kThreads, 0, stream>>>(
      lhs2, zn, t2, rhs, wn, bt, mask, nullptr, counts, B, Np, D, x_min);
  return (int)cudaGetLastError();
}

extern "C" int chyp_rank_sweep_nomask(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int* gold, int* counts, int B,
                                      int Np, int D, float x_min,
                                      cudaStream_t stream) {
  if (B <= 0 || Np <= 0) return 0;
  chyp_sweep_kernel<false><<<sweep_grid(B, Np), kThreads, 0, stream>>>(
      lhs2, zn, t2, rhs, wn, bt, nullptr, gold, counts, B, Np, D, x_min);
  return (int)cudaGetLastError();
}

extern "C" int chyp_rank_filtered_sub(const float* lhs2, const float* zn,
                                      const float* t2, const float* rhs,
                                      const float* wn, const float* bt,
                                      const int* fidx, const int* gold,
                                      int* sub, int B, int Np, int D, int L,
                                      float x_min, cudaStream_t stream) {
  if (B <= 0) return 0;
  chyp_filtered_sub_kernel<<<B, kSubThreads, 0, stream>>>(
      lhs2, zn, t2, rhs, wn, bt, fidx, gold, sub, B, Np, D, L, x_min);
  return (int)cudaGetLastError();
}
