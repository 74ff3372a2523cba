// Bitmap intersection count for Hopper (sm_90a).
//
// Replaces repro/kernels/bitmap.py:bitmap_and_count_pallas (_and_count_kernel):
//   repro_bitmap_and_count: counts[i] = sum over w of popcount(A[i,w] & B[i,w])
//
// Contract: a_words and b_words (B, W) int32 bitmaps (32 keys a word),
// rows contiguous, W a multiple of 4 and both base addresses 16-byte
// aligned (the wrapper checks); counts (B,) int32.
//
// Bound on an H100 SXM: bytes. Both bitmaps are read once (8 bytes a word
// pair) and 4 bytes a row written, at 3.35 TB/s; an AND and a popcount a
// word are far below the integer rate.
//
// Design (simple first; the TPU kernel walks a row in grid steps of TW =
// 256 words and carries the sum in its output block across them, which
// runs in order on one core): one block of 256 threads per row; each
// thread strides over the row in 16-byte loads (four words of each
// bitmap, neighbouring threads on neighbouring addresses), sums __popc of
// the four ANDs, and a warp shuffle plus a shared-memory step reduce the
// block's sums to the row's count. No cross-block reduction, no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
bitmap_and_count_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                        int* __restrict__ counts, int quads) {
  __shared__ int warp_sums[kThreads / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int4* __restrict__ arow = a + static_cast<size_t>(row) * quads;
  const int4* __restrict__ brow = b + static_cast<size_t>(row) * quads;
  int v = 0;
  for (int q = tid; q < quads; q += kThreads) {
    const int4 x = arow[q], y = brow[q];
    v += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
  }
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    int w = tid < kThreads / 32 ? warp_sums[tid] : 0;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(kFull, w, off);
    if (tid == 0) counts[row] = w;
  }
}

}  // namespace

// a_words, b_words (B, W) int32, W % 4 == 0, 16-byte aligned; counts (B,).
extern "C" int repro_bitmap_and_count(const int* a_words, const int* b_words,
                                      int* counts, int batch, int words,
                                      void* stream) {
  if (batch < 0 || words < 4 || words % 4 ||
      reinterpret_cast<uintptr_t>(a_words) % 16 ||
      reinterpret_cast<uintptr_t>(b_words) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  bitmap_and_count_kernel<<<batch, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(a_words),
      reinterpret_cast<const int4*>(b_words), counts, words / 4);
  return static_cast<int>(cudaGetLastError());
}
