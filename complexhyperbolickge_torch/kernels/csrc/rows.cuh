// What the row kernels share: the sorted segment sum (K9, segsum.cu) and the
// row gather (K10, gather.cu) both give each output row a few lanes of a
// warp (one warp when a row has 32 or more vector columns, several rows a
// warp below that), and the lanes of a row stride its columns with 16-byte
// loads and stores (float4 / double2 / 8 bf16 as a uint4) where H and both
// pointers allow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rows {

constexpr int kThreads = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;  // 8 bf16, element 2i in the low half of word i
  static constexpr int width = 8;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// vec: 16-byte columns; cols: columns (of the vector or the element) per
// row; lanes: lanes per row (min(cols, 32)); rpw: rows per warp (32 /
// lanes); blocks: of kThreads, enough for n_rows rows.
struct Geometry {
  bool vec;
  int cols, lanes, rpw;
  unsigned blocks;
};

template <typename T>
Geometry geometry(int n_rows, int h, const void* in, const void* out) {
  Geometry g;
  g.vec = h % Vec<T>::width == 0 && aligned16(in) && aligned16(out);
  g.cols = g.vec ? h / Vec<T>::width : h;
  g.lanes = g.cols < 32 ? g.cols : 32;
  g.rpw = 32 / g.lanes;
  const long long warps = ((long long)n_rows + g.rpw - 1) / g.rpw;
  g.blocks = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  return g;
}

// The row this thread serves and its first column (it strides by lanes);
// false when the thread has no row.
__device__ __forceinline__ bool thread_row(int n_rows, int lanes, int rpw,
                                           long long* row, int* col) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / lanes;
  if (sub >= rpw) return false;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  *row = warp * rpw + sub;
  *col = lane - sub * lanes;
  return *row < n_rows;
}

}  // namespace rows
