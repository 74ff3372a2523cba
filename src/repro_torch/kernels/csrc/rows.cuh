// Row helpers shared by the kernels of this directory: sorted int32 rows,
// either padded with SENTINEL = 2^31-1 to a fixed capacity or read straight
// from a CSR neighbour list (see intersect.cu for the contract), searched,
// staged into shared memory by asynchronous copies and intersected.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Row operands. A row is a (pointer, length) pair, with the values beside its
// keys when the caller has any (vals == nullptr: every value is 1.0). A row
// source maps (operand r, batch row i) to a row:
//   PaddedRows  row (r, i) of a (k, B, cap) SENTINEL-padded stack: cap keys,
//               the padding inside them;
//   CsrRows     the neighbours of vertex ids[r * B + i] in a CSR, cut at the
//               operand's cap: indices[indptr[v] : indptr[v] + min(deg, cap)],
//               exactly the live part of graph/csr.py:padded_rows.
// kPadded tells the window search whether SENTINEL can sit inside a row.
constexpr int kMaxRefs = 8;

struct Row {
  const int* keys;
  const float* vals;
  int n;
};

struct PaddedRows {
  static constexpr bool kPadded = true;
  const int* keys;
  const float* vals;
  int rows, cap;
  __device__ __forceinline__ Row row(int r, int i) const {
    const size_t at = (static_cast<size_t>(r) * rows + i) * cap;
    return {keys + at, vals ? vals + at : nullptr, cap};
  }
};

struct CsrRows {
  static constexpr bool kPadded = false;
  const int* indptr;
  const int* indices;
  const float* values;
  const int* ids;
  int rows;
  int caps[kMaxRefs];
  __device__ __forceinline__ Row row(int r, int i) const {
    const int v = ids[static_cast<size_t>(r) * rows + i];
    const int start = indptr[v];
    const int deg = indptr[v + 1] - start;
    return {indices + start, values ? values + start : nullptr,
            deg < caps[r] ? deg : caps[r]};
  }
};

// [lo, hi) of keys[0, n)'s keys inside (lb, ub), by the 32 lanes of one warp
// (keys in device or shared memory). Keys are >= 0, so lb < 0 needs no
// search; a CSR row holds no SENTINEL, so ub == SENTINEL ends it at n.
template <bool kPadded>
__device__ __forceinline__ int2 warp_window(const int* keys, int n, int lb, int ub) {
  const int lo = lb < 0 ? 0 : warp_lower_bound(keys, 0, n, lb + 1);
  const int hi = (!kPadded && ub == kSentinel) ? n : warp_lower_bound(keys, lo, n, ub);
  return make_int2(lo, hi);
}

// One end of the window: the first key >= lb + 1 (lower end) or >= ub
// (upper end), each searched by its own warp so that the two ends of a
// row's window cost one search's latency.
template <bool kPadded>
__device__ __forceinline__ int warp_window_end(const int* keys, int n, int lb, int ub,
                                               bool upper) {
  if (!upper) return lb < 0 ? 0 : warp_lower_bound(keys, 0, n, lb + 1);
  return (!kPadded && ub == kSentinel) ? n : warp_lower_bound(keys, 0, n, ub);
}

// Asynchronous copy (cp.async) of n 4-byte words from device memory into
// shared memory. `slice` is 16-byte aligned with room for n + 3 words; word
// 0 lands at slice + (src's word offset mod 4), so that the body moves in
// 16-byte transfers whatever 4-byte boundary src starts on, and the head
// and tail move a word at a time. The `nlanes` threads of rank `lane` each
// issue their share; returns where word 0 landed. Each issuing thread waits
// with async_wait_all before a barrier makes the words visible to others.
template <typename T>
__device__ __forceinline__ T* stage_async(T* slice, const T* src, int n,
                                          int lane, int nlanes) {
  static_assert(sizeof(T) == 4, "4-byte words");
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  T* dst = slice + shift;
  int head = (4 - shift) & 3;
  head = head < n ? head : n;
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  for (int w = lane; w < head; w += nlanes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + w));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + w));
  }
  for (int c = lane; c < body; c += nlanes) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + head + 4 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + head + 4 * c));
  }
  for (int w = tail + lane; w < n; w += nlanes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + w));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + w));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return dst;
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory words a row of n words takes in a staging slice
// (stage_async's alignment slack, rounded to keep the next one aligned).
__device__ __host__ __forceinline__ int stage_need(int n) { return (n + 6) & ~3; }

// Lower bounds of four keys in row[0, n), in lockstep: the steps depend on
// n only, so the four searches' loads overlap and a warp never diverges.
__device__ __forceinline__ void lower_bound4(const int* __restrict__ row, int n,
                                             const int (&key)[4], int (&pos)[4]) {
  int base[4] = {0, 0, 0, 0};
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) base[j] = row[base[j] + half] < key[j] ? base[j] + half : base[j];
    len -= half;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) pos[j] = base[j] + (len == 1 && row[base[j]] < key[j]);
}

// Where a thread's kept keys go in one step of a team that packs
// survivors in order: each thread holds four consecutive keys' keep flags,
// threads in rank order. Returns (kept by lower ranks, kept by the whole
// team) from a __ballot_sync per flag and __popc of the words; a block
// team (kWarp false) adds each warp's total through `warp_kept`, one slot a
// warp, a barrier between the write and the read. Give consecutive steps
// alternate `warp_kept` buffers: a step's writes then never meet a slower
// warp's reads of the step before, and one barrier a step suffices. With
// kFlag, `*flag` comes in as this thread's flag and goes out as the OR over
// the team, riding the same words (a warp's total is at most 128, so bit 16
// carries its flag). Every thread of the team calls it.
template <bool kWarp, bool kFlag = false>
__device__ __forceinline__ int2 team_pack_offsets(const int (&keep)[4], int* warp_kept,
                                                  bool* flag = nullptr) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int before = 0, total = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned word = __ballot_sync(kFull, keep[j]);
    before += __popc(word & below);
    total += __popc(word);
  }
  bool any = false;
  if constexpr (kFlag) any = __any_sync(kFull, *flag);
  if constexpr (!kWarp) {
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_kept[warp] = total | (static_cast<int>(any) << 16);
    __syncthreads();
    total = 0;
    const int nwarps = blockDim.x >> 5;
    for (int w = 0; w < nwarps; ++w) {
      int c = warp_kept[w];
      if constexpr (kFlag) any = any || (c >> 16);
      c &= 0xffff;
      before += w < warp ? c : 0;
      total += c;
    }
  }
  if constexpr (kFlag) *flag = any;
  return make_int2(before, total);
}

// Merge path: how many of a's keys come among the first d of the merge of
// a[0, na) and b[0, nb), a's key first on a tie.
__device__ __forceinline__ int merge_path(const int* __restrict__ a, int na,
                                          const int* __restrict__ b, int nb,
                                          int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int ilog2_ceil(int n) {
  return n > 1 ? 32 - __clz(n - 1) : 0;
}

// |a[0, na) ∩ b[0, nb)| of two sorted sets of keys below SENTINEL, this
// thread's share of a team of `nlanes` threads (the caller sums the team).
// Per-key binary search into b when a is much the shorter (each thread
// takes every nlanes-th key of a); else merge path: thread `lane` takes
// the lane-th equal slice of the merge, finds its start with one binary
// search on its diagonal, and walks its slice, counting a key of a when it
// equals b's key at the cursor (a's key goes first on a tie, so each match
// is counted once, by the thread that consumes it).
__device__ __forceinline__ int team_intersect_count(const int* __restrict__ a, int na,
                                                    const int* __restrict__ b, int nb,
                                                    int lane, int nlanes) {
  if (na == 0 || nb == 0) return 0;
  const int total = na + nb;
  const int per = (total + nlanes - 1) / nlanes;
  const int search_cost = ((na + nlanes - 1) / nlanes) * (ilog2_ceil(nb) + 1);
  const int merge_cost = per + ilog2_ceil(na < nb ? na : nb) + 1;
  int hits = 0;
  if (search_cost <= merge_cost) {
    for (int s = lane; s < na; s += nlanes) hits += contains(b, nb, a[s]);
    return hits;
  }
  const int d = lane * per;
  if (d >= total) return 0;
  int i = merge_path(a, na, b, nb, d);
  int j = d - i;
  const int steps = total - d < per ? total - d : per;
  int ka = i < na ? a[i] : kSentinel;
  int kb = j < nb ? b[j] : kSentinel;
  for (int t = 0; t < steps; ++t) {   // i + j < total: one side is live
    if (ka <= kb) {
      hits += ka == kb;
      ++i;
      ka = i < na ? a[i] : kSentinel;
    } else {
      ++j;
      kb = j < nb ? b[j] : kSentinel;
    }
  }
  return hits;
}

}  // namespace
