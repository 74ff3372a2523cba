// Per-row stream compaction for Hopper (sm_90a).
//
// Replaces repro/kernels/compact.py:compact_rows_pallas (_compact_rows_kernel):
//   repro_compact_rows: per row i, keep slot s iff keep[i,s] > 0 and
//   a[i,s] != SENTINEL; rows[i] = the kept keys of a[i] in order,
//   front-packed, SENTINEL after, cut at out_cap; counts[i] = the number
//   kept (not cut).
//
// Contract: a (B, cap) int32, rows contiguous (sorted sets padded with
// SENTINEL = 2^31-1 at the end, so a row's first SENTINEL ends its keys);
// keep (B, cap) contiguous, 1-byte bool (keep_bytes 1) or int32
// (keep_bytes 4); rows (B, out_cap) int32 and counts (B,) int32 written in
// full. Any cap and out_cap >= 1.
//
// Bound on an H100 SXM: bytes. The least read is a's keys and keep's
// flags up to each row's first SENTINEL, the write all of rows (out_cap
// slots a row) and counts, at 3.35 TB/s; the scan is a few integer
// operations a slot.
//
// Design (simple first; the TPU kernel's (out_cap x cap) one-hot compare,
// a matrix-unit gather that never leaves VMEM, is not carried over): one
// block of 256 threads per row walks the row in tiles of 256 slots, one
// slot a thread (coalesced loads). Each warp's keep flags are a
// __ballot_sync word: a lane's slot among the kept ones is the popcount of
// the word below it, plus the kept counts of the warps before it (eight
// words in shared memory), plus the running count of earlier tiles. Kept
// keys are stored at that slot while it is below out_cap. A tile that
// starts at SENTINEL ends the row (the rest is padding), so the padding
// is never read. The slots past the row's count get SENTINEL; thread 0
// writes the count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename KeepT>
__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const int* __restrict__ a, const KeepT* __restrict__ keep,
                    int* __restrict__ rows, int* __restrict__ counts, int cap,
                    int out_cap) {
  __shared__ int warp_kept[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* __restrict__ arow = a + static_cast<size_t>(row) * cap;
  const KeepT* __restrict__ krow = keep + static_cast<size_t>(row) * cap;
  int* __restrict__ orow = rows + static_cast<size_t>(row) * out_cap;
  const unsigned below = (1u << lane) - 1u;

  int kept = 0;                        // kept slots of the earlier tiles
  for (int t0 = 0; t0 < cap; t0 += kThreads) {
    if (arow[t0] == kSentinel) break;  // the same for every thread
    const int s = t0 + tid;
    int key = kSentinel;
    bool flag = false;
    if (s < cap) {
      key = arow[s];
      flag = key != kSentinel && krow[s] > 0;
    }
    const unsigned word = __ballot_sync(kFull, flag);
    if (lane == 0) warp_kept[warp] = __popc(word);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_kept[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    const int pos = kept + before + __popc(word & below);
    if (flag && pos < out_cap) orow[pos] = key;
    kept += tile;
    __syncthreads();                   // warp_kept is rewritten next tile
  }
  for (int s = (kept < out_cap ? kept : out_cap) + tid; s < out_cap; s += kThreads)
    orow[s] = kSentinel;
  if (tid == 0) counts[row] = kept;
}

}  // namespace

// a (B, cap) int32; keep (B, cap) bool (keep_bytes 1) or int32 (4); rows
// (B, out_cap) int32; counts (B,) int32.
extern "C" int repro_compact_rows(const int* a, const void* keep, int* rows,
                                  int* counts, int batch, int cap, int out_cap,
                                  int keep_bytes, void* stream) {
  if (batch < 0 || cap < 1 || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_bytes == 1) {
    compact_rows_kernel<uint8_t><<<batch, kThreads, 0, s>>>(
        a, static_cast<const uint8_t*>(keep), rows, counts, cap, out_cap);
  } else if (keep_bytes == 4) {
    compact_rows_kernel<int><<<batch, kThreads, 0, s>>>(
        a, static_cast<const int*>(keep), rows, counts, cap, out_cap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
