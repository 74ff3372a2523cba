// Batched bounded sorted-row intersection for Hopper (sm_90a).
//
// Replaces the five Pallas kernels on the mining main path:
//   repro_intersect_count  <- repro/kernels/intersect.py:intersect_count_pallas
//   repro_intersect_count_csr (_count_kernel): counts (B,); the _csr entry
//                             reads its rows straight from the CSR
//   repro_intersect_expand <- repro/kernels/intersect.py:intersect_expand_pallas
//                             (_expand_kernel): mark (B, cap_a) and counts (B,)
//   repro_intersect_mark   <- repro/kernels/intersect.py:intersect_mark_pallas
//                             (_mark_kernel): mark (B, cap_a)
//   repro_intersect_multi  <- repro/kernels/intersect.py:intersect_multi_pallas
//                             (_multi_kernel): k-reference mark and counts,
//                             contract further down
//   repro_intersect_multi_agg <- repro/kernels/intersect.py:
//   repro_intersect_multi_agg_csr  intersect_multi_agg_pallas
//                             (_multi_agg_kernel): the k-reference level with
//                             the SVPU value lane, contract at the end; the
//                             _csr entry (the engine's aggregate leaf) reads
//                             keys and values from the CSR and writes no mark
//
// Contract (count, expand, mark): rows of a (B, cap_a) and b (B, cap_b) are
// sorted int32 sets padded with SENTINEL = 2^31-1. Slot s of row i counts iff
//   a[i,s] != SENTINEL, lbounds[i] < a[i,s] < bounds[i], a[i,s] in b[i,:].
// bounds == NULL means SENTINEL, lbounds == NULL means -1. Bound 0 kills a
// row (the engine folds padding and residual-failing items into it). The
// _csr entries take a row as the neighbours of a vertex, cut at a cap
// (rows.cuh, CsrRows): the same keys graph/csr.py:padded_rows gathers.
//
// Bound on an H100 SXM: the kernels move bytes, not operations. Each reads
// at most B*(cap_a+cap_b)*4 bytes of rows, and at least the keys inside each
// row's (lbound, bound) window, plus 8 bytes of bounds per row; it writes
// 4 bytes per row of counts and/or B*cap_a*4 of mark; all at 3.35 TB/s.
// The compare work is ~log2(cap_b) integer operations per A key, far below
// the card's integer rate.
//
// Design of expand and mark (the first version, one block a row):
//   * warp 0 finds B's window of keys inside (lbound, bound) and warp 1
//     A's window, each by a 32-way warp-cooperative search. Slots outside
//     the window are never searched (the TPU schedule's whole-tile skip);
//   * B's window is staged in shared memory when it fits kStageKeys (32 KB),
//     else searched in global memory (the degree buckets reach 32768 keys);
//   * threads stride over A's window and binary-search the staged window,
//     writing the mark row in full (0 outside A's window);
//   * a warp-shuffle plus shared-memory block reduction gives the count.
// The count kernel's redesign is described where it is defined.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kStageKeys = 8192;
constexpr int kWarpRowCap = 1024;   // rows of at most this many keys: a warp a row
constexpr int kRowWarps = 4;        // rows (warps) per block in that mode

// Block-wide sum of each thread's v; thread 0 writes it to *out. Every
// thread of the block must call it: it holds a __syncthreads.
__device__ __forceinline__ void block_sum_to(int v, int* warp_sums, int* out) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if ((tid & 31) == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int w = tid < nwarps ? warp_sums[tid] : 0;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(kFull, w, off);
    if (tid == 0) *out = w;
  }
}

template <bool kMark, bool kCount>
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

  if constexpr (kCount) block_sum_to(hits, warp_sums, counts + row);
}

template <bool kMark, bool kCount>
int launch(const int* a, const int* b, const int* bounds, const int* lbounds,
           int* mark, int* counts, int rows, int cap_a, int cap_b,
           void* stream) {
  const int threads = cap_a >= 2048 ? 256 : 128;
  const int stage_keys = cap_b < kStageKeys ? cap_b : kStageKeys;
  intersect_rows_kernel<kMark, kCount>
      <<<rows, threads, stage_keys * sizeof(int),
         static_cast<cudaStream_t>(stream)>>>(a, b, bounds, lbounds, mark,
                                              counts, cap_a, cap_b,
                                              stage_keys);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// repro_intersect_count and repro_intersect_count_csr: the count leaf.
//
// Operands: A's rows and B's rows each come from a row source (rows.cuh):
// a padded (B, cap) matrix or a CSR, so the engine's count leaf passes
// vertex ids and no gathered matrix crosses device memory. The bound is the
// one above with B*4 bytes of counts written; nothing else.
//
// At the main path's shapes a row is a few hundred keys and the kernel's
// time is the latency of each row's chain of dependent loads, not bytes.
// The design shortens that chain:
//   * rows whose caps are at most kWarpRowCap (1024) run one warp a row,
//     kRowWarps rows a block, with no block barrier: a 128-key row does not
//     leave three warps idle. The warp stages both whole rows into shared
//     memory with asynchronous copies (cp.async: 16-byte transfers for the
//     aligned body, words for the head and tail, since a CSR row starts on
//     any 4-byte boundary), waits once, and finds both windows (the keys
//     inside (lbound, bound)) in shared memory: one round trip to device
//     memory after the row's start, where a window search in device memory
//     costs several;
//   * longer rows keep a block a row (128 threads): its four warps find the
//     four ends of the two windows at once (a 32-way search each), then the
//     block stages both windows with cp.async while they
//     fit kStageKeys / 2 each, and compares in shared memory; a longer
//     window is read in device memory;
//   * the compare (team_intersect_count) is a merge path when the two
//     windows are of similar length: each thread takes one diagonal, one
//     binary search, then a linear merge of its slice. It keeps the per-key
//     binary search where A's window is much the shorter;
//   * a warp shuffle (and across warps, shared memory) sums the row.
template <bool kWarp, class ARows, class BRows>
__global__ void count_kernel(ARows A, BRows B, const int* __restrict__ bounds,
                             const int* __restrict__ lbounds,
                             int* __restrict__ counts, int rows, int stage_a,
                             int stage_b) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int win[4];          // block a row: a_lo, a_hi, b_lo, b_hi
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * kRowWarps + warp : blockIdx.x;
  if (kWarp && row >= rows) return;   // a whole warp; no block barrier follows
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  // keys are in (lb, ub) and ub <= SENTINEL, so SENTINEL never qualifies
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;
  int hits = 0;
  if constexpr (kWarp) {
    if (!dead) {
      const Row a = A.row(0, row);
      const Row b = B.row(0, row);
      int* slice = smem + warp * (stage_a + stage_b + 8);
      const int* ak = stage_async(slice, a.keys, a.n, lane, 32);
      const int* bk = stage_async(slice + stage_a + 4, b.keys, b.n, lane, 32);
      async_wait_all();
      __syncwarp();
      const int2 aw = warp_window<ARows::kPadded>(ak, a.n, lb, ub);
      const int2 bw = warp_window<BRows::kPadded>(bk, b.n, lb, ub);
      hits = team_intersect_count(ak + aw.x, aw.y - aw.x, bk + bw.x, bw.y - bw.x,
                                  lane, 32);
    }
    for (int off = 16; off > 0; off >>= 1) hits += __shfl_down_sync(kFull, hits, off);
    if (lane == 0) counts[row] = hits;
  } else {
    Row a{}, b{};
    if (!dead) {
      a = A.row(0, row);
      b = B.row(0, row);
      if (warp < 2) {
        const int end = warp_window_end<ARows::kPadded>(a.keys, a.n, lb, ub, warp == 1);
        if (lane == 0) win[warp] = end;
      } else if (warp < 4) {
        const int end = warp_window_end<BRows::kPadded>(b.keys, b.n, lb, ub, warp == 3);
        if (lane == 0) win[warp] = end;
      }
    }
    __syncthreads();
    // lb + 1 < ub on a live row, so each window's lower end <= its upper
    const int na = win[1] - win[0], nb = win[3] - win[2];
    const bool stage = !dead && na > 0 && nb > 0;
    if (stage) {
      if (na <= stage_a) stage_async(smem, a.keys + win[0], na, threadIdx.x, blockDim.x);
      if (nb <= stage_b)
        stage_async(smem + stage_a + 4, b.keys + win[2], nb, threadIdx.x, blockDim.x);
      async_wait_all();
    }
    __syncthreads();
    if (stage) {
      const int* asrc = a.keys + win[0];
      const int* bsrc = b.keys + win[2];
      const int* ap = na <= stage_a ? smem + ((reinterpret_cast<uintptr_t>(asrc) >> 2) & 3)
                                    : asrc;
      const int* bp = nb <= stage_b
          ? smem + stage_a + 4 + ((reinterpret_cast<uintptr_t>(bsrc) >> 2) & 3)
          : bsrc;
      hits = team_intersect_count(ap, na, bp, nb, threadIdx.x, blockDim.x);
    }
    block_sum_to(hits, warp_sums, counts + row);
  }
}

template <class ARows, class BRows>
int launch_count(ARows A, BRows B, const int* bounds, const int* lbounds,
                 int* counts, int rows, int cap_a, int cap_b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sa = (cap_a + 3) & ~3, sb = (cap_b + 3) & ~3;
  if (cap_a <= kWarpRowCap && cap_b <= kWarpRowCap) {
    count_kernel<true><<<(rows + kRowWarps - 1) / kRowWarps, 32 * kRowWarps,
                         kRowWarps * (sa + sb + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, counts, rows, sa, sb);
  } else {
    const int half = kStageKeys / 2;
    const int stage_a = sa < half ? sa : half, stage_b = sb < half ? sb : half;
    // 128 threads: the four window ends need four warps, and more resident
    // rows hide more of each row's load latency than wider blocks would
    count_kernel<false><<<rows, 128, (stage_a + stage_b + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, counts, rows, stage_a, stage_b);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// k-reference level: repro_intersect_multi
//
// Contract: bs is the (k, B, cap_b) stack of reference rows, each a sorted
// SENTINEL-padded set (a narrower ref is padded with SENTINEL to cap_b); the
// first n_inter refs are INTER, the rest SUB. Slot s of row i is kept iff
// a[i,s] is in every INTER ref's row i, in no SUB ref's row i,
// lbounds[i] < a[i,s] < bounds[i] (so a[i,s] != SENTINEL) and
// a[i,s] != excludes[i,e] for every e < n_excl (-1 is a no-op: keys are
// >= 0). mark (B, cap_a) is 1 on kept slots and 0 elsewhere; counts (B,)
// counts them. bounds/lbounds NULL as above; excludes NULL when n_excl == 0.
//
// Bound: bytes again. The least read is the window keys of A and of each
// ref (a key outside (lbound, bound) can neither be kept nor decide a kept
// key), the bounds and the excludes; the writes are the mark and the
// counts. Compare work is at most k binary searches per A window key.
//
// Design (simple first): the rows kernel with a loop over refs. The TPU
// kernel streams each ref's B-tiles past a resident A-tile and scores hits
// +1 (INTER) / -(k+1) (SUB), a tiling artifact; here each thread searches
// ref by ref for its key and stops at the first INTER miss or SUB hit.
//   * one block per row; warps find A's window and each ref's window (the
//     same 32-way search), a warp per ref in turn;
//   * refs are staged in shared memory in order while their windows fit
//     kStageKeys together; a ref past that is searched in global memory;
//   * the mark row is written in full (0 outside A's window), and the
//     block sum gives the count.
__global__ void intersect_multi_kernel(const int* __restrict__ a,
                                       const int* __restrict__ bs,
                                       const int* __restrict__ bounds,
                                       const int* __restrict__ lbounds,
                                       const int* __restrict__ excludes,
                                       int* __restrict__ mark,
                                       int* __restrict__ counts, int rows,
                                       int cap_a, int cap_b, int k,
                                       int n_inter, int n_excl,
                                       int stage_keys) {
  extern __shared__ int staged[];
  __shared__ int win[2 * kMaxRefs + 2];   // (lo, hi) per ref, then A's
  __shared__ int off[kMaxRefs];           // staged offset, -1: global
  __shared__ int warp_sums[32];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* __restrict__ arow = a + static_cast<size_t>(row) * cap_a;
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;

  // warp w finds the window of ref w, w + nwarps, ...; index k is A
  for (int r = warp; r <= k; r += nwarps) {
    const int* rrow = r < k ? bs + (static_cast<size_t>(r) * rows + row) * cap_b
                            : arow;
    const int n = r < k ? cap_b : cap_a;
    int lo = 0, hi = 0;
    if (!dead) {
      lo = warp_lower_bound(rrow, 0, n, lb + 1);
      hi = warp_lower_bound(rrow, lo, n, ub);
    }
    if ((tid & 31) == 0) {
      win[2 * r] = lo;
      win[2 * r + 1] = hi;
    }
  }
  __syncthreads();
  const int a_lo = win[2 * k], a_hi = win[2 * k + 1];
  if (tid == 0) {
    int used = 0;
    for (int r = 0; r < k; ++r) {
      const int nb = win[2 * r + 1] - win[2 * r];
      off[r] = (a_hi > a_lo && used + nb <= stage_keys) ? used : -1;
      if (off[r] >= 0) used += nb;
    }
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    if (off[r] < 0) continue;
    const int* rrow = bs + (static_cast<size_t>(r) * rows + row) * cap_b + win[2 * r];
    const int nb = win[2 * r + 1] - win[2 * r];
    for (int i = tid; i < nb; i += blockDim.x) staged[off[r] + i] = rrow[i];
  }
  __syncthreads();

  const int* __restrict__ erow =
      n_excl ? excludes + static_cast<size_t>(row) * n_excl : nullptr;
  int* __restrict__ mrow = mark + static_cast<size_t>(row) * cap_a;
  int kept_here = 0;
  for (int s = tid; s < cap_a; s += blockDim.x) {
    int keep = 0;
    if (s >= a_lo && s < a_hi) {
      const int key = arow[s];
      keep = 1;
      for (int e = 0; e < n_excl && keep; ++e) keep = erow[e] != key;
      for (int r = 0; r < k && keep; ++r) {
        const int nb = win[2 * r + 1] - win[2 * r];
        const int* rw = off[r] >= 0
            ? staged + off[r]
            : bs + (static_cast<size_t>(r) * rows + row) * cap_b + win[2 * r];
        keep = contains(rw, nb, key) == (r < n_inter);
      }
    }
    mrow[s] = keep;
    kept_here += keep;
  }
  block_sum_to(kept_here, warp_sums, counts + row);
}

// ---------------------------------------------------------------------------
// k-reference level with the SVPU value lane: repro_intersect_multi_agg and
// repro_intersect_multi_agg_csr
//
// Contract: repro_intersect_multi's, plus values beside the keys of A and of
// each reference (SUB refs' values are not read), scale (B,) f32 and op
// (0 sum, 1 max, 2 min). Kept slot s of row i carries
//   a_val[i,s] * v_0 * v_1 * ... * scale[i],
// v_r the value beside a[i,s] in INTER ref r, multiplied in that order (the
// plain version's), each product rounded with __fmul_rn, so every product
// agrees bit for bit; vals[i] reduces the kept slots with op, and a row with
// none (bound 0 among them) gives 0.0f, -3.4e38f or +3.4e38f. The row
// reduction runs in double and rounds once to f32: a sum that f32 holds
// exactly comes out exact in any order.
//   repro_intersect_multi_agg: a (B, cap_a), a_vals (B, cap_a), bs and
//     b_vals (k, B, cap_b); writes mark (B, cap_a), counts and vals;
//   repro_intersect_multi_agg_csr (the engine's aggregate leaf): reference
//     r of row i is the neighbour list of vbs[r, i] cut at caps[r], its
//     values edge_values beside it; A is a padded (B, cap_a) matrix with
//     a_vals (NULL: every value 1.0, a carried base) or the neighbours of
//     va[i] cut at cap_a with their edge values (a fresh base). It writes
//     counts and vals and no mark: the leaf never reads one.
//
// Bound: bytes, as repro_intersect_multi's, plus the values beside the
// window keys of A and of each INTER ref and the scale, read once, and 8
// bytes a row of counts and vals written (plus the mark, where written).
//
// Design, as the count kernel's: a warp a row when every cap is at most
// kWarpRowCap, else a block a row. A warp stages each reference's whole row
// (keys, and values for INTER refs) by cp.async while it looks up the next
// rows and A's window: a key inside A's window is in a row iff it is in the
// row's window, so no reference window is searched. A block finds the ends
// of every window at once (a warp an end) and stages the windows. Both
// stage in order while the rows fit the staging budget: a quarter of what a
// block may use on this card (the opt-in maximum, 227 KB on an H100),
// shared among a block's rows; a row past it is read in device memory.
// Each thread takes every team-th key of A's window (loading the next
// key and value while it searches the current one) and binary-searches
// each reference in turn, stopping at the first INTER miss or SUB hit; the
// search gives the matched value's position. (A merge path against the
// first reference, the count kernel's compare, measured slower here: the
// value lane settles each key inside the merge with the warp diverged.)
// Partials reduce by warp shuffles, then across warps through shared
// memory.
constexpr float kF32Max = 3.4e38f;   // the JAX package's F32_MAX, in f32

__device__ __forceinline__ double agg_identity(int op) {
  return op == 0 ? 0.0 : (op == 1 ? -static_cast<double>(kF32Max)
                                  : static_cast<double>(kF32Max));
}

__device__ __forceinline__ double agg_combine(int op, double x, double y) {
  return op == 0 ? x + y : (op == 1 ? fmax(x, y) : fmin(x, y));
}

// Block-wide op-reduction of each thread's v; thread 0 writes it, rounded
// to f32, to *out. Every thread must call it: it holds a __syncthreads.
__device__ __forceinline__ void block_agg_to(double v, int op,
                                             double* warp_vals, float* out) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = agg_combine(op, v, __shfl_down_sync(kFull, v, off));
  if ((tid & 31) == 0) warp_vals[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    double w = tid < nwarps ? warp_vals[tid] : agg_identity(op);
    for (int off = 16; off > 0; off >>= 1)
      w = agg_combine(op, w, __shfl_down_sync(kFull, w, off));
    if (tid == 0) *out = static_cast<float>(w);
  }
}

// One row's reference windows: where each one's keys and values are read
// (staged in shared memory or in device memory), and its length.
struct RefWindows {
  const int* keys[kMaxRefs];
  const float* vals[kMaxRefs];
  int n[kMaxRefs];
  int src_lo[kMaxRefs];   // a block a row: each window's lower end
  int a_lo, a_hi;
};

// Shared-memory words a window of n words takes in a staging slice
// (stage_async's alignment slack, rounded to keep the next one aligned).
__device__ __host__ __forceinline__ int stage_need(int n) { return (n + 6) & ~3; }

template <bool kWarp, bool kMark, class ARows, class BRows>
__global__ void multi_agg_kernel(ARows A, BRows Bs, const int* __restrict__ bounds,
                                 const int* __restrict__ lbounds,
                                 const int* __restrict__ excludes,
                                 const float* __restrict__ scale,
                                 int* __restrict__ mark, int* __restrict__ counts,
                                 float* __restrict__ vals, int rows, int cap_a,
                                 int k, int n_inter, int n_excl, int stage_words,
                                 int op) {
  extern __shared__ __align__(16) int smem[];
  __shared__ RefWindows wins_all[kWarp ? kRowWarps : 1];
  __shared__ int warp_sums[32];
  __shared__ double warp_vals[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * kRowWarps + warp : blockIdx.x;
  if (kWarp && row >= rows) return;   // a whole warp; no block barrier follows
  const int rank = kWarp ? lane : static_cast<int>(threadIdx.x);
  const int team = kWarp ? 32 : static_cast<int>(blockDim.x);
  RefWindows& w = wins_all[kWarp ? warp : 0];
  int* slice = smem + (kWarp ? warp * stage_words : 0);
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;
  Row a{};
  int a_lo = 0, a_hi = 0;
  if (!dead) {
    a = A.row(0, row);
    int used = 0;
    if constexpr (kWarp) {
      // each reference's whole row (its values too if INTER) is staged
      // while the next rows and A's window are looked up: a key inside A's
      // window is in a row iff it is in the row's window, so no reference
      // window is searched
#pragma unroll
      for (int r = 0; r < kMaxRefs; ++r) {
        if (r >= k) break;
        const Row b = Bs.row(r, row);
        const int need = stage_need(b.n) * (r < n_inter ? 2 : 1);
        const int* kp = b.keys;
        const float* vp = b.vals;
        if (used + need <= stage_words) {
          kp = stage_async(slice + used, b.keys, b.n, lane, 32);
          if (r < n_inter)
            vp = stage_async(reinterpret_cast<float*>(slice + used + stage_need(b.n)),
                             b.vals, b.n, lane, 32);
          used += need;
        }
        if (lane == 0) {
          w.keys[r] = kp;
          w.vals[r] = vp;
          w.n[r] = b.n;
        }
      }
      const int2 aw = warp_window<ARows::kPadded>(a.keys, a.n, lb, ub);
      a_lo = aw.x;
      a_hi = aw.y;
      async_wait_all();
      __syncwarp();
    } else {
      // warp w finds end w & 1 (lower, upper) of operand w >> 1's window,
      // then w + nwarps, ...: all ends at once; operand k is A
      const int nwarps = blockDim.x >> 5;
      for (int e = warp; e < 2 * (k + 1); e += nwarps) {
        const int r = e >> 1;
        const Row b = r < k ? Bs.row(r, row) : a;
        const int end = r < k
            ? warp_window_end<BRows::kPadded>(b.keys, b.n, lb, ub, e & 1)
            : warp_window_end<ARows::kPadded>(b.keys, b.n, lb, ub, e & 1);
        if (lane == 0) {
          if (r == k) {
            (e & 1 ? w.a_hi : w.a_lo) = end;
          } else if (e & 1) {
            w.n[r] = end;          // the upper end, until the lower is known
          } else {
            w.keys[r] = b.keys + end;
            w.vals[r] = b.vals + end;
            w.src_lo[r] = end;
          }
        }
      }
      __syncthreads();
      a_lo = w.a_lo;
      a_hi = w.a_hi;
      // every thread walks the same greedy allocation, and issues its share
      const int* kp[kMaxRefs];
      const float* vp[kMaxRefs];
      int nbs[kMaxRefs];
#pragma unroll
      for (int r = 0; r < kMaxRefs; ++r) {
        if (r >= k) break;
        kp[r] = w.keys[r];
        vp[r] = w.vals[r];
        const int nb = w.n[r] - w.src_lo[r];
        nbs[r] = nb;
        const int need = stage_need(nb) * (r < n_inter ? 2 : 1);
        if (a_hi > a_lo && used + need <= stage_words) {
          kp[r] = stage_async(slice + used, kp[r], nb, rank, team);
          if (r < n_inter)
            vp[r] = stage_async(reinterpret_cast<float*>(slice + used + stage_need(nb)),
                                vp[r], nb, rank, team);
          used += need;
        }
      }
      async_wait_all();
      __syncthreads();   // every thread has read w's device pointers
      if (rank == 0) {
#pragma unroll
        for (int r = 0; r < kMaxRefs; ++r) {
          if (r >= k) break;
          w.keys[r] = kp[r];
          w.vals[r] = vp[r];
          w.n[r] = nbs[r];
        }
      }
    }
  }
  if constexpr (!kWarp) __syncthreads();

  const int* __restrict__ erow =
      n_excl ? excludes + static_cast<size_t>(row) * n_excl : nullptr;
  int* __restrict__ mrow = kMark ? mark + static_cast<size_t>(row) * cap_a : nullptr;
  const float sc = scale[row];
  int kept_here = 0;
  double acc = agg_identity(op);
  // every thread takes every team-th key of A's window and searches each
  // ref in turn, stopping at the first INTER miss or SUB hit; the next
  // key's loads from device memory run under this key's search
  int s = a_lo + rank;
  int key_next = s < a_hi ? a.keys[s] : 0;
  float v_next = s < a_hi && a.vals ? a.vals[s] : 1.0f;
  for (; s < a_hi; s += team) {
    const int key = key_next;
    float v = v_next;
    if (s + team < a_hi) {
      key_next = a.keys[s + team];
      if (a.vals) v_next = a.vals[s + team];
    }
    int keep = 1;
    for (int e = 0; e < n_excl && keep; ++e) keep = erow[e] != key;
    for (int r = 0; r < k && keep; ++r) {
      const int nb = w.n[r];
      const int* bk = w.keys[r];
      const int p = lower_bound(bk, nb, key);
      keep = (p < nb && bk[p] == key) == (r < n_inter);
      if (keep && r < n_inter) v = __fmul_rn(v, w.vals[r][p]);
    }
    if (keep) acc = agg_combine(op, acc, static_cast<double>(__fmul_rn(v, sc)));
    if constexpr (kMark) mrow[s] = keep;
    kept_here += keep;
  }
  if constexpr (kMark) {
    for (int s = rank; s < cap_a; s += team)
      if (s < a_lo || s >= a_hi) mrow[s] = 0;
  }
  if constexpr (kWarp) {
    for (int off = 16; off > 0; off >>= 1) {
      kept_here += __shfl_down_sync(kFull, kept_here, off);
      acc = agg_combine(op, acc, __shfl_down_sync(kFull, acc, off));
    }
    if (lane == 0) {
      counts[row] = kept_here;
      vals[row] = static_cast<float>(acc);
    }
  } else {
    block_sum_to(kept_here, warp_sums, counts + row);
    block_agg_to(acc, op, warp_vals, vals + row);
  }
}

// Shared memory a block may use on the current device (the opt-in maximum).
int smem_optin_bytes() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 48 * 1024;
  if (cached[dev] == 0) {
    int bytes = 48 * 1024;
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cached[dev] = bytes;
  }
  return cached[dev];
}

template <bool kWarp, bool kMark, class ARows, class BRows>
int launch_multi_agg_as(ARows A, BRows Bs, const int* bounds, const int* lbounds,
                        const int* excludes, const float* scale, int* mark,
                        int* counts, float* vals, int rows, int cap_a,
                        const int* caps, int k, int n_inter, int n_excl, int op,
                        cudaStream_t st) {
  // the staging budget: a quarter of the block maximum, shared by the rows
  // of a block; each ref's row needs its cap's keys (and values if INTER)
  const int teams = kWarp ? kRowWarps : 1;
  int need = 0;
  for (int r = 0; r < k; ++r) need += stage_need(caps[r]) * (r < n_inter ? 2 : 1);
  int budget = (smem_optin_bytes() / 4 / static_cast<int>(sizeof(int)) / teams) & ~3;
  const int stage_words = need < budget ? need : budget;
  const size_t bytes = static_cast<size_t>(teams) * stage_words * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        multi_agg_kernel<kWarp, kMark, ARows, BRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = kWarp ? 32 * kRowWarps : (cap_a >= 2048 ? 256 : 128);
  const int blocks = kWarp ? (rows + kRowWarps - 1) / kRowWarps : rows;
  multi_agg_kernel<kWarp, kMark><<<blocks, threads, bytes, st>>>(
      A, Bs, bounds, lbounds, excludes, scale, mark, counts, vals, rows, cap_a, k,
      n_inter, n_excl, stage_words, op);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMark, class ARows, class BRows>
int launch_multi_agg(ARows A, BRows Bs, const int* bounds, const int* lbounds,
                     const int* excludes, const float* scale, int* mark,
                     int* counts, float* vals, int rows, int cap_a,
                     const int* caps, int k, int n_inter, int n_excl, int op,
                     void* stream) {
  if (k < 1 || k > kMaxRefs || n_inter < 0 || n_inter > k || n_excl < 0 ||
      op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  bool short_rows = cap_a <= kWarpRowCap;
  for (int r = 0; r < k; ++r) short_rows = short_rows && caps[r] <= kWarpRowCap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_rows)
    return launch_multi_agg_as<true, kMark>(A, Bs, bounds, lbounds, excludes, scale,
                                            mark, counts, vals, rows, cap_a, caps,
                                            k, n_inter, n_excl, op, st);
  return launch_multi_agg_as<false, kMark>(A, Bs, bounds, lbounds, excludes, scale,
                                           mark, counts, vals, rows, cap_a, caps, k,
                                           n_inter, n_excl, op, st);
}

}  // namespace

extern "C" int repro_intersect_count(const int* a, const int* b,
                                     const int* bounds, const int* lbounds,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, void* stream) {
  return launch_count(PaddedRows{a, nullptr, rows, cap_a},
                      PaddedRows{b, nullptr, rows, cap_b}, bounds, lbounds,
                      counts, rows, cap_a, cap_b, stream);
}

// B's row i: the neighbours of vb[i] cut at cap_b. A's row i: a's row
// (a != NULL, (B, cap_a) padded) or the neighbours of va[i] cut at cap_a.
extern "C" int repro_intersect_count_csr(const int* indptr, const int* indices,
                                         const int* a, const int* va,
                                         const int* vb, const int* bounds,
                                         const int* lbounds, int* counts,
                                         int rows, int cap_a, int cap_b,
                                         void* stream) {
  const CsrRows B{indptr, indices, nullptr, vb, rows, {cap_b}};
  if (a)
    return launch_count(PaddedRows{a, nullptr, rows, cap_a}, B, bounds, lbounds,
                        counts, rows, cap_a, cap_b, stream);
  return launch_count(CsrRows{indptr, indices, nullptr, va, rows, {cap_a}}, B,
                      bounds, lbounds, counts, rows, cap_a, cap_b, stream);
}

extern "C" int repro_intersect_expand(const int* a, const int* b,
                                      const int* bounds, const int* lbounds,
                                      int* mark, int* counts, int rows,
                                      int cap_a, int cap_b, void* stream) {
  return launch<true, true>(a, b, bounds, lbounds, mark, counts, rows, cap_a,
                            cap_b, stream);
}

extern "C" int repro_intersect_mark(const int* a, const int* b,
                                    const int* bounds, const int* lbounds,
                                    int* mark, int rows, int cap_a, int cap_b,
                                    void* stream) {
  return launch<true, false>(a, b, bounds, lbounds, mark, nullptr, rows, cap_a,
                             cap_b, stream);
}

// bs (k, B, cap_b); excludes (B, n_excl) or NULL with n_excl == 0; k <= 8.
extern "C" int repro_intersect_multi(const int* a, const int* bs,
                                     const int* bounds, const int* lbounds,
                                     const int* excludes, int* mark,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, int k, int n_inter,
                                     int n_excl, void* stream) {
  if (k < 1 || k > kMaxRefs || n_inter < 0 || n_inter > k || n_excl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cap_a >= 2048 ? 256 : 128;
  const int total = k * cap_b;
  const int stage_keys = total < kStageKeys ? total : kStageKeys;
  intersect_multi_kernel<<<rows, threads, stage_keys * sizeof(int),
                           static_cast<cudaStream_t>(stream)>>>(
      a, bs, bounds, lbounds, excludes, mark, counts, rows, cap_a, cap_b, k,
      n_inter, n_excl, stage_keys);
  return static_cast<int>(cudaGetLastError());
}

// As repro_intersect_multi, plus a_vals (B, cap_a), b_vals (k, B, cap_b),
// scale (B,) f32 in and vals (B,) f32 out; op 0 sum, 1 max, 2 min.
extern "C" int repro_intersect_multi_agg(
    const int* a, const int* bs, const int* bounds, const int* lbounds,
    const int* excludes, const float* a_vals, const float* b_vals,
    const float* scale, int* mark, int* counts, float* vals, int rows,
    int cap_a, int cap_b, int k, int n_inter, int n_excl, int op,
    void* stream) {
  const int caps[kMaxRefs] = {cap_b, cap_b, cap_b, cap_b, cap_b, cap_b, cap_b, cap_b};
  return launch_multi_agg<true>(PaddedRows{a, a_vals, rows, cap_a},
                                PaddedRows{bs, b_vals, rows, cap_b}, bounds,
                                lbounds, excludes, scale, mark, counts, vals, rows,
                                cap_a, caps, k, n_inter, n_excl, op, stream);
}

// The aggregate leaf: reference r of row i is the neighbour list of
// vbs[r * rows + i] cut at cap_r, with edge_values beside it; A is a
// (a_vals NULL: values 1.0) or, when a is NULL, the neighbours of va[i] cut
// at cap_a with their edge values. counts and vals out; no mark.
extern "C" int repro_intersect_multi_agg_csr(
    const int* indptr, const int* indices, const float* edge_values,
    const int* a, const float* a_vals, const int* va, const int* vbs,
    const int* bounds, const int* lbounds, const int* excludes,
    const float* scale, int* counts, float* vals, int rows, int cap_a, int k,
    int n_inter, int n_excl, int op, int cap0, int cap1, int cap2, int cap3,
    int cap4, int cap5, int cap6, int cap7, void* stream) {
  const CsrRows Bs{indptr, indices, edge_values, vbs, rows,
                   {cap0, cap1, cap2, cap3, cap4, cap5, cap6, cap7}};
  if (a)
    return launch_multi_agg<false>(PaddedRows{a, a_vals, rows, cap_a}, Bs, bounds,
                                   lbounds, excludes, scale, nullptr, counts, vals,
                                   rows, cap_a, Bs.caps, k, n_inter, n_excl, op,
                                   stream);
  return launch_multi_agg<false>(CsrRows{indptr, indices, edge_values, va, rows, {cap_a}},
                                 Bs, bounds, lbounds, excludes, scale, nullptr, counts,
                                 vals, rows, cap_a, Bs.caps, k, n_inter, n_excl, op,
                                 stream);
}
