// Search helpers shared by the kernels of this directory: sorted int32
// rows padded with SENTINEL = 2^31-1 (see intersect.cu for the contract).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// First index in row[lo, hi) whose key is >= key (hi when none); called by
// all 32 lanes of one warp, which probe 32 pivots per round.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ row,
                                                int lo, int hi, int key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const bool less = idx < hi && row[idx] < key;
    const int c = __popc(__ballot_sync(kFull, less));
    if (c == 0) return lo;  // row[lo] >= key
    const int nhi = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  const int idx = lo + lane;
  const bool less = idx < hi && row[idx] < key;
  return lo + __popc(__ballot_sync(kFull, less));
}

// First index in row[0, n) whose key is >= key (n when none); one thread.
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool contains(const int* __restrict__ row, int n,
                                         int key) {
  const int p = lower_bound(row, n, key);
  return p < n && row[p] == key;
}

}  // namespace
