// Batched bounded sorted-row intersection for Hopper (sm_90a).
//
// Replaces the two Pallas kernels on the mining main path:
//   repro_intersect_count  <- repro/kernels/intersect.py:intersect_count_pallas
//                             (_count_kernel): counts (B,)
//   repro_intersect_expand <- repro/kernels/intersect.py:intersect_expand_pallas
//                             (_expand_kernel): mark (B, cap_a) and counts (B,)
//
// Contract (both): rows of a (B, cap_a) and b (B, cap_b) are sorted int32
// sets padded with SENTINEL = 2^31-1. Slot s of row i counts iff
//   a[i,s] != SENTINEL, lbounds[i] < a[i,s] < bounds[i], a[i,s] in b[i,:].
// bounds == NULL means SENTINEL, lbounds == NULL means -1. Bound 0 kills a
// row (the engine folds padding and residual-failing items into it).
//
// Bound on an H100 SXM: the kernels move bytes, not operations. Each reads
// at most B*(cap_a+cap_b)*4 bytes of rows, and at least the keys inside each
// row's (lbound, bound) window, plus 8 bytes of bounds per row; it writes
// 4 bytes per row (plus B*cap_a*4 of mark for expand); all at 3.35 TB/s.
// The compare work is ~log2(cap_b) integer operations per A key, far below
// the card's integer rate.
//
// Design against that bound (simple first; the tiling of the TPU kernel,
// an all-pairs 128x128 tile compare fed by a DMA schedule, is not carried
// over):
//   * one block per row, so no reduction crosses blocks and no atomics;
//   * warp 0 finds B's window of keys inside (lbound, bound) and warp 1
//     A's window, each by a 32-way warp-cooperative search (three rounds of
//     coalesced probes for a 32768-key row). Slots outside the window are
//     never searched: the counterpart of the TPU schedule's whole-tile skip
//     and of its early exit at the bound. Dead rows read nothing else;
//   * B's window is staged in shared memory when it fits kStageKeys (32 KB,
//     so several blocks stay resident per SM), else searched in global
//     memory (the degree buckets reach 32768 keys = 128 KB);
//   * threads stride over A's window (coalesced loads) and binary-search
//     the staged window; expand writes its mark row in the same pass;
//   * a warp-shuffle plus shared-memory block reduction gives the count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kStageKeys = 8192;
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

__device__ __forceinline__ bool contains(const int* __restrict__ row, int n,
                                         int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < n && row[lo] == key;
}

template <bool kMark>
__global__ void intersect_rows_kernel(const int* __restrict__ a,
                                      const int* __restrict__ b,
                                      const int* __restrict__ bounds,
                                      const int* __restrict__ lbounds,
                                      int* __restrict__ mark,
                                      int* __restrict__ counts,
                                      int cap_a, int cap_b, int stage_keys) {
  extern __shared__ int staged[];
  __shared__ int win[4];          // a_lo, a_hi, b_lo, b_hi
  __shared__ int warp_sums[32];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int* __restrict__ arow = a + static_cast<size_t>(row) * cap_a;
  const int* __restrict__ brow = b + static_cast<size_t>(row) * cap_b;
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  // keys are in (lb, ub) and ub <= SENTINEL, so SENTINEL never qualifies
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;

  if (warp < 2) {
    int lo = 0, hi = 0;
    if (!dead) {
      const int* r = warp == 0 ? brow : arow;
      const int n = warp == 0 ? cap_b : cap_a;
      lo = warp_lower_bound(r, 0, n, lb + 1);
      hi = warp_lower_bound(r, lo, n, ub);
    }
    if ((tid & 31) == 0) {
      win[warp == 0 ? 2 : 0] = lo;
      win[warp == 0 ? 3 : 1] = hi;
    }
  }
  __syncthreads();
  const int a_lo = win[0], a_hi = win[1], b_lo = win[2];
  const int nb = win[1] > win[0] ? win[3] - b_lo : 0;

  const bool stage = nb <= stage_keys;
  if (stage) {
    for (int i = tid; i < nb; i += blockDim.x) staged[i] = brow[b_lo + i];
  }
  __syncthreads();
  const int* __restrict__ bw = stage ? staged : brow + b_lo;

  int hits = 0;
  if constexpr (kMark) {
    int* __restrict__ mrow = mark + static_cast<size_t>(row) * cap_a;
    for (int s = tid; s < cap_a; s += blockDim.x) {
      int hit = 0;
      if (s >= a_lo && s < a_hi) hit = contains(bw, nb, arow[s]);
      mrow[s] = hit;
      hits += hit;
    }
  } else {
    for (int s = a_lo + tid; s < a_hi; s += blockDim.x) {
      hits += contains(bw, nb, arow[s]);
    }
  }

  for (int off = 16; off > 0; off >>= 1) hits += __shfl_down_sync(kFull, hits, off);
  if ((tid & 31) == 0) warp_sums[warp] = hits;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int v = tid < nwarps ? warp_sums[tid] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (tid == 0) counts[row] = v;
  }
}

template <bool kMark>
int launch(const int* a, const int* b, const int* bounds, const int* lbounds,
           int* mark, int* counts, int rows, int cap_a, int cap_b,
           void* stream) {
  const int threads = cap_a >= 2048 ? 256 : 128;
  const int stage_keys = cap_b < kStageKeys ? cap_b : kStageKeys;
  intersect_rows_kernel<kMark>
      <<<rows, threads, stage_keys * sizeof(int),
         static_cast<cudaStream_t>(stream)>>>(a, b, bounds, lbounds, mark,
                                              counts, cap_a, cap_b,
                                              stage_keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_intersect_count(const int* a, const int* b,
                                     const int* bounds, const int* lbounds,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, void* stream) {
  return launch<false>(a, b, bounds, lbounds, nullptr, counts, rows, cap_a,
                       cap_b, stream);
}

extern "C" int repro_intersect_expand(const int* a, const int* b,
                                      const int* bounds, const int* lbounds,
                                      int* mark, int* counts, int rows,
                                      int cap_a, int cap_b, void* stream) {
  return launch<true>(a, b, bounds, lbounds, mark, counts, rows, cap_a, cap_b,
                      stream);
}
