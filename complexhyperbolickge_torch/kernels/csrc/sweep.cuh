// What the all-entity rank sweeps share: the complex-hyperbolic sweeps
// (K1, K2; chyp_rank.cu) and the real-hyperbolic ones (K5-K8; hyp_rank.cu)
// stage their operands into shared memory with cp.async while the other
// buffer computes, and launch one persistent grid sized by the occupancy
// API: blocks_per_sm resident blocks on each SM, each a contiguous range
// of (query tile, entity tile) items.

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
