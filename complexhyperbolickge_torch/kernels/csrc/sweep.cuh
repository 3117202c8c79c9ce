// What the all-entity rank sweeps share: the complex-hyperbolic sweeps
// (K1, K2; chyp_rank.cu) and the real-hyperbolic ones (K5-K8; hyp_rank.cu)
// stage their operands into shared memory with cp.async while the other
// buffer computes, and launch one persistent grid sized by the occupancy
// API: blocks_per_sm resident blocks on each SM, each a contiguous range
// of (query tile, entity tile) items.  Their bf16 instances (precision
// "default") contract with the warp-level tensor-core product mma_bf16
// (K1/K2's loading its fragments with ldmatrix_x4); the arithmetic of their
// epilogues is in epilogue.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace rank_sweeps {

constexpr int kMaxDevices = 64;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Asynchronous copies into shared memory; src_bytes < the copy's size
// zero-fills the rest (0: a zero-filled slot, src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A stage's place in a block's walk: query tile, entity tile, feature chunk.
struct StagePos {
  int qt, et, chunk;
};

// The stage after p: feature chunks fastest, then entity tiles, then query
// tiles.
__device__ __forceinline__ StagePos next_pos(StagePos p, int n_chunks, int n_et) {
  if (++p.chunk == n_chunks) {
    p.chunk = 0;
    if (++p.et == n_et) {
      p.et = 0;
      ++p.qt;
    }
  }
  return p;
}

// The bf16 tensor-core product of the bf16 instances: c += A B over one
// k-step of 16 features, A 16 x 16 (rows), B 16 x 8 (columns), f32
// accumulators, by mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
// With g = lane / 4 and t = lane % 4, the fragments are 32-bit words of two
// bf16 features (the lower feature in the lower half, as a little-endian
// load of a row gives them):
//   a0: A row g,     features 2t, 2t + 1      a2: row g,     features 2t + 8, 2t + 9
//   a1: A row g + 8, features 2t, 2t + 1      a3: row g + 8, features 2t + 8, 2t + 9
//   b0: B column g,  features 2t, 2t + 1      b1: column g,  features 2t + 8, 2t + 9
//   c0, c1: (row g, columns 2t, 2t + 1)       c2, c3: (row g + 8, columns 2t, 2t + 1)
// so a row's k-step is words t and t + 4 of its 8 (rows stored feature-
// contiguous).  An output element depends on its A row, its B column and
// the accumulator it continues only: the same chain of k-steps over the
// same rows gives the same bits wherever the rows sit in the tiles.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory into mma fragments, by
// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane l gives the address of row
// l % 8 of matrix l / 8 (8 bf16 = 16 bytes, 16-byte aligned), and gets in
// r[i] the two features 2t, 2t + 1 of row g of matrix i -- the a0..a3 of an
// A tile whose matrices are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows
// 0-7, k 8-15), (rows 8-15, k 8-15), or the b0, b1 of two n-tiles whose
// matrices are (columns 0-7, k 0-7), (0-7, k 8-15), (8-15, k 0-7), (8-15, k
// 8-15) of B stored column by column.  Rows bf16_row_words() apart are
// conflict-free: the 8 rows of a matrix fall in 8 distinct 16-byte bank
// groups.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Copy words [w0, w0 + nw) (nw a multiple of 4) of rows [r0, r0 + kRows) of
// a table of n rows of ld 32-bit words (16-byte aligned rows) into kRows
// staged rows of dst_ld words, 16 bytes a copy; rows past n are
// zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void copy_words(uint32_t* dst, int dst_ld, const uint32_t* src, int r0,
                                           int n, int ld, int w0, int nw, int tid) {
  const int per_row = nw / 4;
#pragma unroll 1
  for (int idx = tid; idx < kRows * per_row; idx += kThreads) {
    const int r = idx / per_row, p = idx % per_row;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * dst_ld + 4 * p, src + (size_t)(ok ? r0 + r : 0) * ld + w0 + 4 * p,
               ok ? 16 : 0);
  }
}

// Words a staged bf16 row of kc features takes: kc / 2 + 4, an odd multiple
// of 4 modulo 32 when kc is a multiple of 16, so the 8 rows x 4 words of a
// fragment load fall in 32 distinct banks.
__host__ __device__ constexpr int bf16_row_words(int kc) { return kc / 2 + 4; }

// Element t (0-3) of v.
__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : (t == 1 ? v.y : (t == 2 ? v.z : v.w));
}

// A kernel's resident blocks per SM and the device's SMs, per device.
struct Occupancy {
  int per_sm[kMaxDevices], sms[kMaxDevices];
  size_t smem[kMaxDevices];
};

// Resident blocks per SM of `kernel` at `threads` threads and `smem` bytes
// of dynamic shared memory (after allowing it up to `max_smem`) on the
// current device, the device's SMs in *sms; cached in `cache` (one per
// kernel) per device and size.  A negative value is a cudaError_t, negated.
template <typename Kernel>
int blocks_per_sm(Occupancy& cache, Kernel kernel, int threads, size_t smem, int max_smem,
                  int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (cache.per_sm[dev] == 0 || cache.smem[dev] != smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return -(int)err;
    int per_sm = 0, count = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return -(int)err;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    cache.sms[dev] = count;
    cache.per_sm[dev] = per_sm;
    cache.smem[dev] = smem;
  }
  *sms = cache.sms[dev];
  return cache.per_sm[dev];
}

// The persistent grid: one block per item up to the resident blocks.
inline int grid_size(int n_items, int per_sm, int sms) {
  return n_items < per_sm * sms ? n_items : per_sm * sms;
}

// This block's items [*begin, *end) of n_items, contiguous and balanced.
__device__ __forceinline__ void block_items(int n_items, int* begin, int* end) {
  *begin = (int)((long long)n_items * blockIdx.x / gridDim.x);
  *end = (int)((long long)n_items * (blockIdx.x + 1) / gridDim.x);
}

}  // namespace rank_sweeps
