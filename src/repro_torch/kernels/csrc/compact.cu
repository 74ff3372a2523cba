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
// full. Any cap and out_cap >= 1, any 4-byte (a) or 1-byte (bool keep)
// boundary.
//
// Bound on an H100 SXM: bytes. The least read is a's keys and keep's
// flags up to each row's first SENTINEL, the write all of rows (out_cap
// slots a row) and counts, at 3.35 TB/s; the scan is a few integer
// operations a slot.
//
// Design (the TPU kernel's (out_cap x cap) one-hot compare, a matrix-unit
// gather that never leaves VMEM, is not carried over):
//   * A team walks a row four consecutive slots a thread a step: a warp a
//     row (4 rows a 128-thread block, no barrier) for caps up to the
//     wrapper's switch, else a 256-thread block a row (1024 slots a step).
//   * A step's loads are one round: the four keys as one 16-byte load and
//     their flags beside them, unconditionally (a bool mask's four flags as
//     one 32-bit word, an int32 mask's as one 16-byte load). A row whose
//     cap is not a multiple of 4, or whose arrays start off those
//     boundaries (a view with a storage offset), loads its four slots one
//     at a time instead (kVec false, picked by the wrapper).
//   * Positions: rows.cuh:team_pack_offsets, four ballots and __popc; a
//     block team adds its warps' totals through two alternating shared
//     buffers, one barrier a step. The row's end is the first SENTINEL a
//     step's own loads see: the team learns it from the same ballot words
//     and barrier, so no load tests the end ahead of the keys.
//   * Once a row has out_cap survivors it only counts: no more stores.
//   * The tail past min(count, out_cap) gets SENTINEL, 16-byte stores
//     between a scalar head and tail.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kRowWarps = 4;         // warp team: rows (warps) a block
constexpr int kBlockThreads = 256;   // block team: threads a row

// Keys and keep flags of slots s0 .. s0 + 3 of a row (SENTINEL and 0 past
// cap). kVec: one 16-byte load of keys and one 4- or 16-byte load of
// flags (cap % 4 == 0 and aligned rows, so s0 < cap covers all four).
template <typename KeepT, bool kVec>
__device__ __forceinline__ void load_step(const int* __restrict__ arow,
                                          const KeepT* __restrict__ krow, int s0,
                                          int cap, int (&key)[4], int (&flag)[4]) {
  if constexpr (kVec) {
    int4 q = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
    if constexpr (sizeof(KeepT) == 1) {
      unsigned w = 0;
      if (s0 < cap) {
        q = *reinterpret_cast<const int4*>(arow + s0);
        w = *reinterpret_cast<const unsigned*>(krow + s0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) flag[j] = (w >> (8 * j)) & 0xffu;
    } else {
      int4 f = make_int4(0, 0, 0, 0);
      if (s0 < cap) {
        q = *reinterpret_cast<const int4*>(arow + s0);
        f = *reinterpret_cast<const int4*>(krow + s0);
      }
      flag[0] = f.x > 0;
      flag[1] = f.y > 0;
      flag[2] = f.z > 0;
      flag[3] = f.w > 0;
    }
    key[0] = q.x;
    key[1] = q.y;
    key[2] = q.z;
    key[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = s0 + j < cap;
      key[j] = in ? arow[s0 + j] : kSentinel;
      flag[j] = in && krow[s0 + j] > 0;
    }
  }
}

// SENTINEL into orow[from, to): a scalar head to the first 16-byte
// boundary, 16-byte stores, a scalar tail; `rank` of `team` threads.
__device__ __forceinline__ void fill_tail(int* __restrict__ orow, int from, int to,
                                          int rank, int team) {
  int head = static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(orow + from) >> 2) & 3)) & 3);
  head = head < to - from ? head : to - from;
  if (rank < head) orow[from + rank] = kSentinel;
  const int start = from + head;
  const int words = (to - start) >> 2;
  int4* __restrict__ body = reinterpret_cast<int4*>(orow + start);
  const int4 pad = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  for (int c = rank; c < words; c += team) body[c] = pad;
  for (int s = start + 4 * words + rank; s < to; s += team) orow[s] = kSentinel;
}

template <typename KeepT, bool kVec, bool kWarp>
__global__ void __launch_bounds__(kWarp ? 32 * kRowWarps : kBlockThreads)
compact_rows_kernel(const int* __restrict__ a, const KeepT* __restrict__ keep,
                    int* __restrict__ rows, int* __restrict__ counts, int batch,
                    int cap, int out_cap) {
  __shared__ int warp_kept[2][kBlockThreads / 32];
  const int row = kWarp ? blockIdx.x * kRowWarps + (threadIdx.x >> 5) : blockIdx.x;
  if (kWarp && row >= batch) return;   // a whole warp; no block barrier follows
  const int rank = kWarp ? (threadIdx.x & 31) : static_cast<int>(threadIdx.x);
  constexpr int team = kWarp ? 32 : kBlockThreads;
  const int* __restrict__ arow = a + static_cast<size_t>(row) * cap;
  const KeepT* __restrict__ krow = keep + static_cast<size_t>(row) * cap;
  int* __restrict__ orow = rows + static_cast<size_t>(row) * out_cap;

  int kept = 0;                        // the row's survivors so far, the team's
  for (int t0 = 0, step = 0; t0 < cap; t0 += 4 * team, ++step) {
    const int s0 = t0 + 4 * rank;
    int key[4], flag[4], keepj[4];
    load_step<KeepT, kVec>(arow, krow, s0, cap, key, flag);
    bool end = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keepj[j] = flag[j] && key[j] != kSentinel;
      end = end || key[j] == kSentinel;
    }
    const int2 off = team_pack_offsets<kWarp, true>(keepj, warp_kept[step & 1], &end);
    if (kept < out_cap) {              // the same for the whole team
      int p = kept + off.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (keepj[j]) {
          if (p < out_cap) orow[p] = key[j];
          ++p;
        }
      }
    }
    kept += off.y;
    if (end) break;                    // the team saw the row's first SENTINEL
  }
  fill_tail(orow, kept < out_cap ? kept : out_cap, out_cap, rank, team);
  if (rank == 0) counts[row] = kept;
}

template <typename KeepT, bool kVec>
void launch_as(const int* a, const KeepT* keep, int* rows, int* counts, int batch,
               int cap, int out_cap, bool warp, cudaStream_t s) {
  if (warp) {
    compact_rows_kernel<KeepT, kVec, true>
        <<<(batch + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, s>>>(
            a, keep, rows, counts, batch, cap, out_cap);
  } else {
    compact_rows_kernel<KeepT, kVec, false><<<batch, kBlockThreads, 0, s>>>(
        a, keep, rows, counts, batch, cap, out_cap);
  }
}

template <typename KeepT>
void launch_keep(const int* a, const void* keep, int* rows, int* counts, int batch,
                 int cap, int out_cap, bool warp, bool vec, cudaStream_t s) {
  const KeepT* k = static_cast<const KeepT*>(keep);
  if (vec) launch_as<KeepT, true>(a, k, rows, counts, batch, cap, out_cap, warp, s);
  else launch_as<KeepT, false>(a, k, rows, counts, batch, cap, out_cap, warp, s);
}

}  // namespace

// a (B, cap) int32; keep (B, cap) bool (keep_bytes 1) or int32 (4); rows
// (B, out_cap) int32; counts (B,) int32. warp: a warp a row (else a block);
// vec: 16-byte loads, which need cap % 4 == 0, a on a 16-byte boundary and
// keep on a 4-byte (bool) or 16-byte (int32) one.
extern "C" int repro_compact_rows(const int* a, const void* keep, int* rows,
                                  int* counts, int batch, int cap, int out_cap,
                                  int keep_bytes, int warp, int vec, void* stream) {
  if (batch < 0 || cap < 1 || out_cap < 1 || (keep_bytes != 1 && keep_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t keep_align = keep_bytes == 1 ? 4 : 16;
  if (vec && (cap % 4 || reinterpret_cast<uintptr_t>(a) % 16 ||
              reinterpret_cast<uintptr_t>(keep) % keep_align))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_bytes == 1)
    launch_keep<uint8_t>(a, keep, rows, counts, batch, cap, out_cap, warp, vec, s);
  else
    launch_keep<int>(a, keep, rows, counts, batch, cap, out_cap, warp, vec, s);
  return static_cast<int>(cudaGetLastError());
}
