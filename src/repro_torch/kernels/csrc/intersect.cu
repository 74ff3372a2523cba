// Batched bounded sorted-row intersection for Hopper (sm_90a).
//
// Replaces the five Pallas kernels on the mining main path:
//   repro_intersect_count  <- repro/kernels/intersect.py:intersect_count_pallas
//   repro_intersect_count_csr (_count_kernel): counts (B,); the _csr entry
//                             reads its rows straight from the CSR
//   repro_intersect_expand <- repro/kernels/intersect.py:intersect_expand_pallas
//   repro_intersect_expand_csr (_expand_kernel): mark (B, cap_a) and counts
//                             (B,); the _csr entry (the engine's INTER expand
//                             level) reads B's row, and a fresh base's, from
//                             the CSR and writes the survivors front-packed
//                             instead of a mark; repro_expand_items turns
//                             those rows into the level's worklist
//   repro_intersect_mark   <- repro/kernels/intersect.py:intersect_mark_pallas
//   repro_intersect_mark_csr  (_mark_kernel): mark (B, cap_a); the _csr entry
//   repro_intersect_sub_count_csr  (the SUB levels) takes B's row from the
//                             CSR, either polarity and the window inside, and
//                             writes a 1-byte mark; the sub_count entry (the
//                             SUB count leaf) writes counts and no mark
//   repro_intersect_count_worklist, repro_intersect_sub_count_worklist
//                             (_count_kernel, no TPU kernel): a carried count
//                             leaf read in place from its parent's compacted
//                             worklist, summed into one int64; note further
//                             down
//   repro_intersect_multi  <- repro/kernels/intersect.py:intersect_multi_pallas
//   repro_intersect_multi_csr (_multi_kernel): k-reference mark and counts,
//                             contract further down; the _csr entry (general
//                             levels) reads the references from the CSR
//   repro_intersect_multi_count_worklist (no TPU kernel): a general count
//                             leaf read in place from its parent's compacted
//                             worklist, summed into one int64; note at the end
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
// 4 bytes per row of counts and/or B*cap_a*4 of mark (B*cap_a of a 1-byte
// mark; B*out_cap*4 of packed rows); all at 3.35 TB/s. The compare work is
// ~log2(cap_b) integer operations per A key, far below the card's integer
// rate.
//
// The designs (count, expand, and the level template of mark, multi and
// multi-agg) are described where each is defined.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kStageKeys = 8192;
constexpr int kWarpRowCap = 1024;   // rows of at most this many keys: a warp a row
constexpr int kRowWarps = 4;        // rows (warps) per block in that mode

// Block-wide sum of each thread's v; thread 0 writes it to *out (out NULL:
// nowhere). Every thread of the block must call it: it holds a __syncthreads.
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
    if (tid == 0 && out) *out = w;
  }
}

// ---------------------------------------------------------------------------
// repro_intersect_count, repro_intersect_count_csr and (kSub)
// repro_intersect_sub_count_csr: the count leaves.
//
// Operands: A's rows and B's rows each come from a row source (rows.cuh):
// a padded (B, cap) matrix or a CSR, so the engine's count leaf passes
// vertex ids and no gathered matrix crosses device memory. The bound is the
// one above with B*4 bytes of counts written; nothing else.
//
// kSub: the SUB count leaf (an induced non-edge, S_SUB.C) counts
// |A's window| - |A ∩ B inside the window|: a key of A's window is in B iff
// it is in B's window (the same (lbound, bound)), so the complement costs
// what the intersection does, and no mark is written.
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
//
// Where the counts go (Out): RowCounts writes row i's count to counts[i];
// SumInto adds the block's sum to one 64-bit total (the in-place leaf).
struct RowCounts {
  static constexpr bool kSum = false;
  int* counts;
};
struct SumInto {
  static constexpr bool kSum = true;
  unsigned long long* total;
};

template <bool kSub, bool kWarp, class ARows, class BRows, class Out>
__global__ void count_kernel(ARows A, BRows B, const int* __restrict__ bounds,
                             const int* __restrict__ lbounds, Out out, int rows,
                             int stage_a, int stage_b) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int win[4];          // block a row: a_lo, a_hi, b_lo, b_hi
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * kRowWarps + warp : blockIdx.x;
  // a warp past the last row leaves (no block barrier follows), unless the
  // block's sum waits for it: then it is a dead row
  if (kWarp && !Out::kSum && row >= rows) return;
  const bool here = !kWarp || row < rows;
  const int ub = !here ? 0 : bounds ? bounds[row] : kSentinel;
  const int lb = here && lbounds ? lbounds[row] : -1;
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
      if constexpr (kSub) hits = (lane == 0 ? aw.y - aw.x : 0) - hits;
    }
    if constexpr (!Out::kSum) {
      for (int off = 16; off > 0; off >>= 1) hits += __shfl_down_sync(kFull, hits, off);
      if (lane == 0) out.counts[row] = hits;
    }
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
    // (a dead row never writes win: its ends are not read)
    const int na = dead ? 0 : win[1] - win[0], nb = dead ? 0 : win[3] - win[2];
    const bool stage = na > 0 && nb > 0;
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
    if constexpr (kSub) hits = (threadIdx.x == 0 ? na : 0) - hits;
    if constexpr (!Out::kSum) block_sum_to(hits, warp_sums, out.counts + row);
  }
  if constexpr (Out::kSum) {
    // every thread's hits, the block's rows together: one atomic a block
    int sum = 0;
    block_sum_to(hits, warp_sums, &sum);
    if (threadIdx.x == 0 && sum != 0)
      atomicAdd(out.total, static_cast<unsigned long long>(sum));
  }
}

template <bool kSub, class ARows, class BRows, class Out>
int launch_count(ARows A, BRows B, const int* bounds, const int* lbounds, Out out,
                 int rows, int cap_a, int cap_b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sa = (cap_a + 3) & ~3, sb = (cap_b + 3) & ~3;
  if (cap_a <= kWarpRowCap && cap_b <= kWarpRowCap) {
    count_kernel<kSub, true><<<(rows + kRowWarps - 1) / kRowWarps, 32 * kRowWarps,
                               kRowWarps * (sa + sb + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, out, rows, sa, sb);
  } else {
    const int half = kStageKeys / 2;
    const int stage_a = sa < half ? sa : half, stage_b = sb < half ? sb : half;
    // 128 threads: the four window ends need four warps, and more resident
    // rows hide more of each row's load latency than wider blocks would
    count_kernel<kSub, false><<<rows, 128, (stage_a + stage_b + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, out, rows, stage_a, stage_b);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The level kernel: repro_intersect_multi (_csr), repro_intersect_mark
// (_csr) and repro_intersect_multi_agg (_csr), one template.
//
// Contract of multi: bs is the (k, B, cap_b) stack of reference rows, each a
// sorted SENTINEL-padded set (a narrower ref is padded with SENTINEL to
// cap_b); the first n_inter refs are INTER, the rest SUB. Slot s of row i is
// kept iff a[i,s] is in every INTER ref's row i, in no SUB ref's row i,
// lbounds[i] < a[i,s] < bounds[i] (so a[i,s] != SENTINEL) and
// a[i,s] != excludes[i,e] for every e < n_excl (-1 is a no-op: keys are
// >= 0). mark (B, cap_a) is 1 on kept slots and 0 elsewhere; counts (B,)
// counts them. bounds/lbounds NULL as above; excludes NULL when n_excl == 0.
//   repro_intersect_multi: a (B, cap_a), bs (k, B, cap_b); int32 mark and
//     counts (the TPU kernel's contract);
//   repro_intersect_multi_csr (general levels): reference r of row i is the
//     neighbour list of vbs[r, i] cut at caps[r]; A is a padded (B, cap_a)
//     matrix or the neighbours of va[i] cut at cap_a. Either counts and no
//     mark (a count leaf), or a 1-byte mark and no counts (an expand level,
//     whose base is padded rows: the compaction packs its keys).
// Contract of mark: multi's with k = 1 and no excludes.
//   repro_intersect_mark: the TPU kernel's INTER mark, int32;
//   repro_intersect_mark_csr (SUB expand levels, and the fused_level=False
//     and host-path masks): B's row from the CSR, INTER or SUB, a 1-byte
//     mark over a padded A: keep = live ∧ lb < key < ub ∧ (key ∈ B) == INTER,
//     so a SUB level's window is applied here, not in a pass after it.
// Contract of multi-agg: multi's, plus values beside the keys of A and of
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
//   repro_intersect_multi_agg_csr (the engine's aggregate leaf): references
//     as multi_csr's, values edge_values beside them; A is a padded
//     (B, cap_a) matrix with a_vals (NULL: every value 1.0, a carried base)
//     or the neighbours of va[i] cut at cap_a with their edge values (a
//     fresh base). It writes counts and vals and no mark: the leaf never
//     reads one.
//
// Bound: bytes. The least read is the window keys of A and of each ref (a
// key outside (lbound, bound) can neither be kept nor decide a kept key),
// the bounds and the excludes, plus, with the value lane, the values beside
// the window keys of A and of each INTER ref and the scale; the writes are
// the mark (4 or 1 bytes a slot, where written), the counts and the vals.
// Compare work is at most k binary searches per A window key.
//
// Design. The TPU kernel streams each ref's B-tiles past a resident A-tile
// and scores hits +1 (INTER) / -(k+1) (SUB), a tiling artifact; here each
// key searches ref by ref and stops at the first INTER miss or SUB hit.
// A warp a row when every cap is at most kWarpRowCap, else a block a row. A
// warp stages each reference's whole row (keys, and values for INTER refs
// with the value lane) by cp.async: a key inside (lbound, bound) is in a
// row iff it is in the row's window, so no reference window is searched. A
// block finds the ends of every window at once (a warp an end) and stages
// the windows. Both stage in order while the rows fit the staging budget:
// a quarter of what a block may use on this card (the opt-in maximum,
// 227 KB on an H100), shared among a block's rows; a row past it is read in
// device memory.
// A warp finds A's window with the references' copies in flight.
//   * mark and multi (no value lane): each thread takes every team-th group
//     of four slots of A, the next group's loads issued under this group's
//     searches, and searches the four keys in lockstep (a branch-free
//     search whose steps depend on the row's length only: four independent
//     loads a step where a key at a time waits on each; at the warp-a-row
//     shape this halved the count's time). A mark's group is an aligned
//     4-slot word of the padded row: one 16-byte load, and one store of its
//     mark (4 bytes of a 1-byte mark, 16 of an int32 one), zeros outside
//     A's window, so every store is full width and coalesced. A count's
//     group is four consecutive keys of A's window, a CSR row's included.
//     (Reading A's whole row in a warp, each key testing the window
//     itself, took the window search off the row's chain but measured
//     slower for the marks.) A block a row runs 128 threads.
//   * the value lane (multi-agg): each thread takes every
//     team-th key of A's window, loading the next key and value while it
//     searches the current one, and binary-searches each reference in
//     turn; the search gives the matched value's position. (A merge path
//     against the first reference, the count kernel's compare, measured
//     slower with the value lane: it settles each key inside the merge with
//     the warp diverged.)
// Partials reduce by warp shuffles, then across warps through shared
// memory.
constexpr float kF32Max = 3.4e38f;   // the JAX package's F32_MAX, in f32

// Lanes of the level kernel: whether a kept key carries a value, and how
// many references a row has (0: the caller's k). Each names its kernel's
// wrapper in a profile's kernel symbols.
struct AggLane {      // intersect_multi_agg
  static constexpr bool kValues = true;
  static constexpr int kRefs = 0;
};
struct MultiLane {    // intersect_multi
  static constexpr bool kValues = false;
  static constexpr int kRefs = 0;
};
struct MarkLane {     // intersect_mark
  static constexpr bool kValues = false;
  static constexpr int kRefs = 1;
};

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
  int excl[kMaxRefs];     // the row's excludes, where Items stages them
  int a_lo, a_hi;
};

// Where a row's bounds and excludes come from (the level kernel's Items):
//   ItemArrays     (B,) bounds and lbounds (NULL: SENTINEL, -1) and the
//                  (B, n_excl) excludes, in device memory;
//   WorklistItems  columns of a worklist's items (WorklistIds): the upper
//                  bound the least of the ub columns' vertices (SENTINEL
//                  when none), the lower bound the greatest of the lb
//                  columns' (-1 when none), one exclude a column of excl.
// excl(i, slot, rank) returns row i's excludes; WorklistItems writes them
// into slot (shared memory), thread rank e the e-th, so the caller calls it
// with every thread of the row's team before the barrier that follows.
struct ItemArrays {
  const int* bounds;
  const int* lbounds;
  const int* excludes;
  int n_excl;
  __device__ __forceinline__ int ub(int i) const { return bounds ? bounds[i] : kSentinel; }
  __device__ __forceinline__ int lb(int i) const { return lbounds ? lbounds[i] : -1; }
  __device__ __forceinline__ const int* excl(int i, int*, int) const {
    return n_excl ? excludes + static_cast<size_t>(i) * n_excl : nullptr;
  }
};

struct WorklistItems {
  WorklistIds ids;
  unsigned ub_cols, lb_cols;   // bit c: column c bounds the keys
  int excl_col[kMaxRefs];
  int n_excl;
  __device__ __forceinline__ int ub(int i) const {
    int u = kSentinel;
    for (unsigned m = ub_cols; m; m &= m - 1) u = min(u, ids.at(__ffs(m) - 1, i));
    return u;
  }
  __device__ __forceinline__ int lb(int i) const {
    int l = -1;
    for (unsigned m = lb_cols; m; m &= m - 1) l = max(l, ids.at(__ffs(m) - 1, i));
    return l;
  }
  __device__ __forceinline__ const int* excl(int i, int* slot, int rank) const {
    if (rank < n_excl) slot[rank] = ids.at(excl_col[rank], i);
    return slot;
  }
};

// The keys of slots s0 .. s0 + 3 of a row (0 past [a_lo, a_hi)): one
// 16-byte load of an aligned padded word (kWord, when it meets the
// window), else four loads.
template <bool kWord>
__device__ __forceinline__ void load_group(const int* __restrict__ keys, int s0, int a_lo,
                                           int a_hi, int (&key)[4]) {
  if constexpr (kWord) {
    const int4 q = s0 + 4 > a_lo && s0 < a_hi ? *reinterpret_cast<const int4*>(keys + s0)
                                              : make_int4(0, 0, 0, 0);
    key[0] = q.x;
    key[1] = q.y;
    key[2] = q.z;
    key[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = s0 + j < a_hi ? keys[s0 + j] : 0;
  }
}

template <class Lane, bool kWarp, class MarkT, class ARows, class BRows, class Items,
          class Out>
__global__ void level_kernel(ARows A, BRows Bs, Items items,
                             const float* __restrict__ scale, MarkT* __restrict__ mark,
                             Out out, float* __restrict__ vals, int rows, int cap_a,
                             int k_arg, int n_inter, int stage_words, int op) {
  constexpr bool kValues = Lane::kValues;
  constexpr bool kMark = !std::is_void<MarkT>::value;
  // a mark without values is written a 4-slot word at a time from A's
  // 16-byte aligned padded row
  static_assert(kValues || !kMark || ARows::kPadded, "a word mark needs padded A rows");
  static_assert(!Out::kSum || !(kValues || kMark), "a summed count has no mark or values");
  const int k = Lane::kRefs ? Lane::kRefs : k_arg;
  const int n_excl = items.n_excl;
  extern __shared__ __align__(16) int smem[];
  __shared__ RefWindows wins_all[kWarp ? kRowWarps : 1];
  __shared__ int warp_sums[32];
  __shared__ double warp_vals[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * kRowWarps + warp : blockIdx.x;
  // a warp past the last row leaves (no block barrier follows), unless the
  // block's sum waits for it: then it is a dead row
  if (kWarp && !Out::kSum && row >= rows) return;
  const bool here = !kWarp || row < rows;
  const int rank = kWarp ? lane : static_cast<int>(threadIdx.x);
  const int team = kWarp ? 32 : static_cast<int>(blockDim.x);
  RefWindows& w = wins_all[kWarp ? warp : 0];
  int* slice = smem + (kWarp ? warp * stage_words : 0);
  const int ub = here ? items.ub(row) : 0;
  const int lb = here ? items.lb(row) : -1;
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;
  Row a{};
  int a_lo = 0, a_hi = 0;
  const int* __restrict__ erow = nullptr;
  if (!dead) {
    erow = items.excl(row, w.excl, rank);   // visible after the barrier below
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
        const int need = stage_need(b.n) * (kValues && r < n_inter ? 2 : 1);
        const int* kp = b.keys;
        const float* vp = b.vals;
        if (used + need <= stage_words) {
          kp = stage_async(slice + used, b.keys, b.n, lane, 32);
          if (kValues && r < n_inter)
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
        const int need = stage_need(nb) * (kValues && r < n_inter ? 2 : 1);
        if (a_hi > a_lo && used + need <= stage_words) {
          kp[r] = stage_async(slice + used, kp[r], nb, rank, team);
          if (kValues && r < n_inter)
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

  int kept_here = 0;
  double acc = 0.0;
  if constexpr (!kValues) {
    // four slots a step, searched in lockstep: a mark's aligned 4-slot
    // words over the whole row (zeros outside A's window), else four
    // consecutive keys of the window
    const int g_lo = kMark ? 0 : a_lo;
    const int ngroups = ((kMark ? cap_a : a_hi) - g_lo + 3) >> 2;
    int key_next[4];
    load_group<kMark>(a.keys, g_lo + 4 * rank, a_lo, a_hi, key_next);
    for (int g = rank; g < ngroups; g += team) {
      const int s0 = g_lo + 4 * g;
      int key[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) key[j] = key_next[j];
      if (g + team < ngroups) load_group<kMark>(a.keys, s0 + 4 * team, a_lo, a_hi, key_next);
      int keep[4];
      int live = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = s0 + j >= a_lo && s0 + j < a_hi;
        live |= keep[j];
      }
      for (int e = 0; e < n_excl && live; ++e) {
        const int x = erow[e];
#pragma unroll
        for (int j = 0; j < 4; ++j) keep[j] &= x != key[j];
        live = keep[0] | keep[1] | keep[2] | keep[3];
      }
      for (int r = 0; r < k && live; ++r) {
        const int nb = w.n[r];
        const int* bk = w.keys[r];
        int pos[4];
        lower_bound4(bk, nb, key, pos);
        live = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          keep[j] &= (pos[j] < nb && bk[pos[j]] == key[j]) == (r < n_inter);
          live |= keep[j];
        }
      }
      kept_here += keep[0] + keep[1] + keep[2] + keep[3];
      if constexpr (kMark) {
        MarkT* __restrict__ mrow = mark + static_cast<size_t>(row) * cap_a;
        if constexpr (sizeof(MarkT) == 1) {
          reinterpret_cast<unsigned*>(mrow)[g] = static_cast<unsigned>(keep[0])
              | static_cast<unsigned>(keep[1]) << 8 | static_cast<unsigned>(keep[2]) << 16
              | static_cast<unsigned>(keep[3]) << 24;
        } else {
          reinterpret_cast<int4*>(mrow)[g] = make_int4(keep[0], keep[1], keep[2], keep[3]);
        }
      }
    }
  } else {
    // the value lane: every thread takes every team-th key of A's window
    // and searches each ref in turn, stopping at the first INTER miss or
    // SUB hit; the next key's loads from device memory run under this
    // key's search
    MarkT* __restrict__ mrow = nullptr;
    if constexpr (kMark) mrow = mark + static_cast<size_t>(row) * cap_a;
    const float sc = scale[row];
    acc = agg_identity(op);
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
  }
  if constexpr (Out::kSum) {
    // the block's rows together: one atomic a block
    int sum = 0;
    block_sum_to(kept_here, warp_sums, &sum);
    if (threadIdx.x == 0 && sum != 0)
      atomicAdd(out.total, static_cast<unsigned long long>(sum));
  } else if constexpr (kWarp) {
    int* __restrict__ counts = out.counts;
    if (counts) {   // never NULL with the value lane
      for (int off = 16; off > 0; off >>= 1) {
        kept_here += __shfl_down_sync(kFull, kept_here, off);
        if constexpr (kValues) acc = agg_combine(op, acc, __shfl_down_sync(kFull, acc, off));
      }
    }
    if (lane == 0) {
      if (counts) counts[row] = kept_here;
      if constexpr (kValues) vals[row] = static_cast<float>(acc);
    }
  } else {
    block_sum_to(kept_here, warp_sums, out.counts ? out.counts + row : nullptr);
    if constexpr (kValues) block_agg_to(acc, op, warp_vals, vals + row);
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

template <class Lane, bool kWarp, class MarkT, class ARows, class BRows, class Items,
          class Out>
int launch_level_as(ARows A, BRows Bs, Items items, const float* scale, MarkT* mark,
                    Out out, float* vals, int rows, int cap_a, const int* caps, int k,
                    int n_inter, int op, cudaStream_t st) {
  // the staging budget: a quarter of the block maximum, shared by the rows
  // of a block; each ref's row needs its cap's keys (and values if INTER
  // with the value lane)
  const int teams = kWarp ? kRowWarps : 1;
  int need = 0;
  for (int r = 0; r < k; ++r)
    need += stage_need(caps[r]) * (Lane::kValues && r < n_inter ? 2 : 1);
  int budget = (smem_optin_bytes() / 4 / static_cast<int>(sizeof(int)) / teams) & ~3;
  const int stage_words = need < budget ? need : budget;
  const size_t bytes = static_cast<size_t>(teams) * stage_words * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        level_kernel<Lane, kWarp, MarkT, ARows, BRows, Items, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a block a row: 128 threads for mark and multi (measured faster than 256
  // at cap 2048: more resident rows), 256 for the value lane at cap 2048
  const int threads = kWarp ? 32 * kRowWarps
                            : (Lane::kValues && cap_a >= 2048 ? 256 : 128);
  const int blocks = kWarp ? (rows + kRowWarps - 1) / kRowWarps : rows;
  level_kernel<Lane, kWarp><<<blocks, threads, bytes, st>>>(
      A, Bs, items, scale, mark, out, vals, rows, cap_a, k, n_inter, stage_words, op);
  return static_cast<int>(cudaGetLastError());
}

template <class Lane, class MarkT, class ARows, class BRows, class Items, class Out>
int launch_level_of(ARows A, BRows Bs, Items items, const float* scale, MarkT* mark,
                    Out out, float* vals, int rows, int cap_a, const int* caps, int k,
                    int n_inter, int op, void* stream) {
  if (k < 1 || k > kMaxRefs || (Lane::kRefs && k != Lane::kRefs) || n_inter < 0 ||
      n_inter > k || items.n_excl < 0 || op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  bool short_rows = cap_a <= kWarpRowCap;
  for (int r = 0; r < k; ++r) short_rows = short_rows && caps[r] <= kWarpRowCap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_rows)
    return launch_level_as<Lane, true>(A, Bs, items, scale, mark, out, vals, rows, cap_a,
                                       caps, k, n_inter, op, st);
  return launch_level_as<Lane, false>(A, Bs, items, scale, mark, out, vals, rows, cap_a,
                                      caps, k, n_inter, op, st);
}

template <class Lane, class MarkT, class ARows, class BRows>
int launch_level(ARows A, BRows Bs, const int* bounds, const int* lbounds,
                 const int* excludes, const float* scale, MarkT* mark,
                 int* counts, float* vals, int rows, int cap_a,
                 const int* caps, int k, int n_inter, int n_excl, int op,
                 void* stream) {
  return launch_level_of<Lane>(A, Bs, ItemArrays{bounds, lbounds, excludes, n_excl},
                               scale, mark, RowCounts{counts}, vals, rows, cap_a, caps, k,
                               n_inter, op, stream);
}


// ---------------------------------------------------------------------------
// repro_intersect_expand, repro_intersect_expand_csr and repro_expand_items:
// the INTER expand level.
//
// Contract of expand: count's, plus the level's survivors.
//   repro_intersect_expand (the TPU kernel's contract): a (B, cap_a) and b
//     (B, cap_b) padded; mark (B, cap_a) int32, 1 on kept slots, and counts.
//   repro_intersect_expand_csr (the engine's INTER expand level): B's row i
//     the neighbours of vb[i] cut at cap_b; A's row a padded (B, cap_a) a (a
//     carried base) or the neighbours of va[i] cut at cap_a (a fresh base).
//     rows (B, out_cap) int32: row i's kept keys in order, front-packed,
//     SENTINEL after, cut at out_cap; counts (B,) not cut. No mark is
//     written: batch_compact_rows(a, mark, out_cap) is what it computes.
//   repro_expand_items: the level's worklist from those rows. With offs the
//     exclusive prefix sum of counts and no row cut (counts[i] <= out_cap),
//     item offs[i] + j is (src i, vert rows[i, j]) for j < counts[i], and
//     every item from the total on is (0, 0); items past out_items drop.
//     This is core/batch.py:batch_compact_scan's (src, verts) on the same
//     survivors (the JAX package leaves it to XLA's scatter; it is no
//     Pallas kernel).
//
// Bound: bytes. Expand reads count's least bytes and writes the counts plus
// the mark (B*cap_a*4) or the packed rows (B*out_cap*4); the items pass
// reads the live keys, counts and offs and writes out_items*8 bytes.
//
// Design of expand, on the count kernel's and the level template's parts:
//   * caps at most kWarpRowCap run a warp a row, kRowWarps rows a block; a
//     longer row a 128-thread block, whose four warps find the four window
//     ends at once. A warp stages B's whole row (and the CSR form A's) by
//     cp.async and finds the windows in shared memory; a block stages the
//     windows while they fit kStageKeys / 2 each (the mark form B's alone,
//     up to kStageKeys), else reads them in device memory (youtube's
//     buckets reach 32768 keys);
//   * each thread takes four keys a step and searches B's window for them
//     in lockstep (lower_bound4: branch-free, steps that depend on the
//     window's length only);
//   * the mark form takes the padded row's aligned 4-slot words (one
//     16-byte load, one 16-byte store of the mark, zeros outside A's
//     window), as the level template's marks do;
//   * the CSR form takes four consecutive keys of A's window from shared
//     memory (a CSR row starts on any 4-byte boundary, so no aligned word
//     exists in device memory). A step's keep flags become positions by
//     ballots (team_pack_offsets: the lower lanes', across warps the lower
//     warps', plus the row's running count), and the kept keys are stored
//     straight into rows; the tail gets SENTINEL. The (B, cap_a) mark never
//     reaches device memory.
// The items pass runs a warp a row (its count's keys, coalesced) and, in
// the blocks after the rows, the zero tail from the total to out_items.
constexpr int kExpandThreads = 128;   // a block a row

template <bool kPack, bool kWarp, class ARows, class BRows>
__global__ void expand_kernel(ARows A, BRows B, const int* __restrict__ bounds,
                              const int* __restrict__ lbounds, int* __restrict__ out,
                              int* __restrict__ counts, int rows, int cap_a, int out_cap,
                              int stage_a, int stage_b) {
  // the mark form reads A's padded row in aligned 16-byte words
  static_assert(kPack || ARows::kPadded, "a word mark needs padded A rows");
  extern __shared__ __align__(16) int smem[];
  __shared__ int win[4];                                // a block a row: window ends
  __shared__ int warp_kept[2][kExpandThreads / 32];     // a block a row: pack offsets
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * kRowWarps + warp : blockIdx.x;
  if (kWarp && row >= rows) return;   // a whole warp; no block barrier follows
  const int rank = kWarp ? lane : static_cast<int>(threadIdx.x);
  const int team = kWarp ? 32 : static_cast<int>(blockDim.x);
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  // keys are in (lb, ub) and ub <= SENTINEL, so SENTINEL never qualifies
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;
  Row a{}, b{};
  if (!dead) {
    a = A.row(0, row);
    b = B.row(0, row);
  }
  // A's window [a_lo, a_hi) of its row; ap: the CSR form's window keys
  // (staged or in device memory); bp, nb: B's window
  int a_lo = 0, a_hi = 0, nb = 0;
  const int* ap = nullptr;
  const int* bp = nullptr;
  if constexpr (kWarp) {
    if (!dead) {
      int* slice = smem + warp * (stage_a + stage_b + 8);
      const int* bk = stage_async(slice + stage_a + 4, b.keys, b.n, lane, 32);
      const int* ak = kPack ? stage_async(slice, a.keys, a.n, lane, 32) : a.keys;
      int2 aw = make_int2(0, 0);
      if constexpr (!kPack) aw = warp_window<ARows::kPadded>(ak, a.n, lb, ub);  // under the copy
      async_wait_all();
      __syncwarp();
      if constexpr (kPack) aw = warp_window<ARows::kPadded>(ak, a.n, lb, ub);
      const int2 bw = warp_window<BRows::kPadded>(bk, b.n, lb, ub);
      a_lo = aw.x;
      a_hi = aw.y;
      ap = ak + a_lo;
      bp = bk + bw.x;
      nb = bw.y - bw.x;
    }
  } else {
    if (!dead && warp < 4) {
      const int end = warp < 2
          ? warp_window_end<ARows::kPadded>(a.keys, a.n, lb, ub, warp == 1)
          : warp_window_end<BRows::kPadded>(b.keys, b.n, lb, ub, warp == 3);
      if (lane == 0) win[warp] = end;
    }
    __syncthreads();
    // lb + 1 < ub on a live row, so each window's lower end <= its upper
    // (a dead row never writes win: its ends are not read)
    if (!dead) {
      a_lo = win[0];
      a_hi = win[1];
      nb = win[3] - win[2];
      ap = a.keys + a_lo;
      bp = b.keys + win[2];
    }
    const int na = a_hi - a_lo;
    const bool stage_a_win = kPack && na > 0 && nb > 0 && na <= stage_a;
    const bool stage_b_win = na > 0 && nb > 0 && nb <= stage_b;
    if (stage_a_win) stage_async(smem, ap, na, threadIdx.x, blockDim.x);
    if (stage_b_win) stage_async(smem + stage_a + 4, bp, nb, threadIdx.x, blockDim.x);
    if (stage_a_win || stage_b_win) async_wait_all();
    __syncthreads();
    if (stage_a_win) ap = smem + ((reinterpret_cast<uintptr_t>(ap) >> 2) & 3);
    if (stage_b_win) bp = smem + stage_a + 4 + ((reinterpret_cast<uintptr_t>(bp) >> 2) & 3);
  }

  if constexpr (kPack) {
    // an empty B window keeps nothing: the row is its tail alone
    const int na = nb > 0 ? a_hi - a_lo : 0;
    int* __restrict__ orow = out + static_cast<size_t>(row) * out_cap;
    int kept = 0;                        // the row's survivors so far, the team's
    for (int g0 = 0, step = 0; 4 * g0 < na; g0 += team, ++step) {
      const int s0 = 4 * (g0 + rank);
      int key[4], pos[4], keep[4];
      load_group<false>(ap, s0, 0, na, key);
      lower_bound4(bp, nb, key, pos);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        keep[j] = s0 + j < na && pos[j] < nb && bp[pos[j]] == key[j];
      const int2 off = team_pack_offsets<kWarp>(keep, warp_kept[step & 1]);
      int p = kept + off.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (keep[j]) {
          if (p < out_cap) orow[p] = key[j];
          ++p;
        }
      }
      kept += off.y;
    }
    for (int s = (kept < out_cap ? kept : out_cap) + rank; s < out_cap; s += team)
      orow[s] = kSentinel;
    if (rank == 0) counts[row] = kept;
  } else {
    // the int32 mark over the padded row's aligned 4-slot words, zeros
    // outside A's window; the next word's load under this word's search
    int* __restrict__ mrow = out + static_cast<size_t>(row) * cap_a;
    const int ngroups = cap_a >> 2;
    int hits = 0;
    int key_next[4];
    load_group<true>(a.keys, 4 * rank, a_lo, a_hi, key_next);
    for (int g = rank; g < ngroups; g += team) {
      const int s0 = 4 * g;
      int key[4], pos[4], keep[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) key[j] = key_next[j];
      if (g + team < ngroups) load_group<true>(a.keys, s0 + 4 * team, a_lo, a_hi, key_next);
      int live = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = s0 + j >= a_lo && s0 + j < a_hi;
        live |= keep[j];
      }
      if (live) {
        lower_bound4(bp, nb, key, pos);
#pragma unroll
        for (int j = 0; j < 4; ++j) keep[j] &= pos[j] < nb && bp[pos[j]] == key[j];
      }
      reinterpret_cast<int4*>(mrow)[g] = make_int4(keep[0], keep[1], keep[2], keep[3]);
      hits += keep[0] + keep[1] + keep[2] + keep[3];
    }
    if constexpr (kWarp) {
      for (int off = 16; off > 0; off >>= 1) hits += __shfl_down_sync(kFull, hits, off);
      if (lane == 0) counts[row] = hits;
    } else {
      block_sum_to(hits, warp_sums, counts + row);
    }
  }
}

template <bool kPack, class ARows, class BRows>
int launch_expand(ARows A, BRows B, const int* bounds, const int* lbounds, int* out,
                  int* counts, int rows, int cap_a, int cap_b, int out_cap,
                  void* stream) {
  if (rows < 0 || cap_a < 1 || cap_b < 1 || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the mark form searches A's window in device memory: only B is staged
  const int sa = kPack ? (cap_a + 3) & ~3 : 0, sb = (cap_b + 3) & ~3;
  if (cap_a <= kWarpRowCap && cap_b <= kWarpRowCap) {
    expand_kernel<kPack, true><<<(rows + kRowWarps - 1) / kRowWarps, 32 * kRowWarps,
                                 kRowWarps * (sa + sb + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, out, counts, rows, cap_a, out_cap, sa, sb);
  } else {
    const int half = kPack ? kStageKeys / 2 : kStageKeys;
    const int stage_a = sa < half ? sa : half, stage_b = sb < half ? sb : half;
    expand_kernel<kPack, false><<<rows, kExpandThreads,
                                  (stage_a + stage_b + 8) * sizeof(int), st>>>(
        A, B, bounds, lbounds, out, counts, rows, cap_a, out_cap, stage_a, stage_b);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kItemThreads = 256;
constexpr int kItemTailBlocks = 1056;  // eight a streaming multiprocessor, at most

__global__ void __launch_bounds__(kItemThreads)
expand_items_kernel(const int* __restrict__ rows2, const int* __restrict__ counts,
                    const int* __restrict__ offs, int* __restrict__ src,
                    int* __restrict__ verts, int batch, int out_cap, int out_items,
                    int row_blocks) {
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int i = blockIdx.x * (kItemThreads / 32) + (threadIdx.x >> 5);
    if (i >= batch) return;
    const int n = counts[i] < out_cap ? counts[i] : out_cap;
    const int o = offs[i];
    const int* __restrict__ r = rows2 + static_cast<size_t>(i) * out_cap;
    for (int j = threadIdx.x & 31; j < n && o + j < out_items; j += 32) {
      verts[o + j] = r[j];
      src[o + j] = i;
    }
    return;
  }
  // the zero tail [total, out_items): words up to the first multiple of
  // four and past the last one, 16-byte stores between (src and verts
  // start on 16-byte boundaries)
  const int total = batch ? offs[batch - 1] + counts[batch - 1] : 0;
  const int t = (blockIdx.x - row_blocks) * kItemThreads + threadIdx.x;
  const int stride = (gridDim.x - row_blocks) * kItemThreads;
  const int head_end = min((total + 3) & ~3, out_items);
  const int body_end = max(out_items & ~3, head_end);
  for (int p = total + t; p < head_end; p += stride) src[p] = verts[p] = 0;
  for (int p = body_end + t; p < out_items; p += stride) src[p] = verts[p] = 0;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int q = head_end / 4 + t; q < body_end / 4; q += stride) {
    reinterpret_cast<int4*>(src)[q] = zero;
    reinterpret_cast<int4*>(verts)[q] = zero;
  }
}

}  // namespace

extern "C" int repro_intersect_count(const int* a, const int* b,
                                     const int* bounds, const int* lbounds,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, void* stream) {
  return launch_count<false>(PaddedRows{a, nullptr, rows, cap_a},
                             PaddedRows{b, nullptr, rows, cap_b}, bounds, lbounds,
                             RowCounts{counts}, rows, cap_a, cap_b, stream);
}

namespace {

// B's row i: the neighbours of vb[i] cut at cap_b. A's row i: a's row
// (a != NULL, (B, cap_a) padded) or the neighbours of va[i] cut at cap_a.
template <bool kSub>
int count_csr(const int* indptr, const int* indices, const int* a, const int* va,
              const int* vb, const int* bounds, const int* lbounds, int* counts,
              int rows, int cap_a, int cap_b, void* stream) {
  const CsrRows B{indptr, indices, nullptr, vb, rows, {cap_b}};
  if (a)
    return launch_count<kSub>(PaddedRows{a, nullptr, rows, cap_a}, B, bounds, lbounds,
                              RowCounts{counts}, rows, cap_a, cap_b, stream);
  return launch_count<kSub>(CsrRows{indptr, indices, nullptr, va, rows, {cap_a}}, B,
                            bounds, lbounds, RowCounts{counts}, rows, cap_a, cap_b,
                            stream);
}

// The in-place count leaf: repro_intersect_count_worklist and (kSub)
// repro_intersect_sub_count_worklist. It replaces no TPU kernel: the JAX
// engine slices each chunk of a carried leaf out of its parent's worklist
// with XLA ops, and so did the engine here, with about ten PyTorch kernels
// around each count launch (the carry's gather and copy, the vertex
// column, the live mask, the bound, the int64 cast and the sum), each a
// few microseconds of card and many more of host. This entry reads the
// worklist where the parent's expand left it. Item i of the chunk
// [lo, lo + m) has A's row rows2[src[lo + i], :cap_a] (WorklistRows: the
// parent's packed survivors, SENTINEL after them), B's row the neighbours
// of verts2[lo + i] cut at cap_b (CsrRows), and upper bound verts2[lo + i]
// (the leaf's one reference is the parent's new vertex, and so is its
// bound); the counts of the m rows, and no more, are summed into *total.
//
// Bound: bytes, as the count kernel's: the m base rows read through src
// (m * cap_a * 4 bytes at most, the window keys at least), the m B rows
// and 12 bytes an item of src, verts2 and bound; 8 bytes written a block.
//
// Design: count_kernel's template with WorklistRows as A and SumInto as
// its output (the same warp-a-row and block-a-row paths, so the counts
// are the sliced leaf's). A block's rows sum in shared memory and thread 0
// adds the block's total into the int64 with one 64-bit atomic: no
// per-row counts, no cast and no reduction launch. A row starts wherever
// src puts it; the staging copies move its aligned body in 16-byte words
// and its head and tail a word at a time, so an out_cap that is not a
// multiple of 4 keys costs the scalar words only.
template <bool kSub>
int count_worklist(const int* indptr, const int* indices, const int* rows2,
                   const int* src, const int* verts2, long long* total, int lo, int m,
                   int out_cap, int cap_a, int cap_b, void* stream) {
  if (lo < 0 || m < 0 || cap_a < 1 || cap_a > out_cap || cap_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  return launch_count<kSub>(WorklistRows{rows2, src + lo, out_cap, cap_a},
                            CsrRows{indptr, indices, nullptr, verts2 + lo, m, {cap_b}},
                            verts2 + lo, nullptr,
                            SumInto{reinterpret_cast<unsigned long long*>(total)}, m,
                            cap_a, cap_b, stream);
}

}  // namespace

extern "C" int repro_intersect_count_csr(const int* indptr, const int* indices,
                                         const int* a, const int* va,
                                         const int* vb, const int* bounds,
                                         const int* lbounds, int* counts,
                                         int rows, int cap_a, int cap_b,
                                         void* stream) {
  return count_csr<false>(indptr, indices, a, va, vb, bounds, lbounds, counts, rows,
                          cap_a, cap_b, stream);
}

// As repro_intersect_count_csr, counting the keys of A's window NOT in B.
extern "C" int repro_intersect_sub_count_csr(const int* indptr, const int* indices,
                                             const int* a, const int* va,
                                             const int* vb, const int* bounds,
                                             const int* lbounds, int* counts,
                                             int rows, int cap_a, int cap_b,
                                             void* stream) {
  return count_csr<true>(indptr, indices, a, va, vb, bounds, lbounds, counts, rows,
                         cap_a, cap_b, stream);
}

// rows2 (B, out_cap) and src, verts2 (items,) in: the chunk [lo, lo + m) of
// the worklist; total, one int64, accumulates.
extern "C" int repro_intersect_count_worklist(const int* indptr, const int* indices,
                                              const int* rows2, const int* src,
                                              const int* verts2, long long* total,
                                              int lo, int m, int out_cap, int cap_a,
                                              int cap_b, void* stream) {
  return count_worklist<false>(indptr, indices, rows2, src, verts2, total, lo, m, out_cap,
                               cap_a, cap_b, stream);
}

// As repro_intersect_count_worklist, counting the keys of A's window NOT in B.
extern "C" int repro_intersect_sub_count_worklist(const int* indptr, const int* indices,
                                                  const int* rows2, const int* src,
                                                  const int* verts2, long long* total,
                                                  int lo, int m, int out_cap, int cap_a,
                                                  int cap_b, void* stream) {
  return count_worklist<true>(indptr, indices, rows2, src, verts2, total, lo, m, out_cap,
                              cap_a, cap_b, stream);
}

extern "C" int repro_intersect_expand(const int* a, const int* b,
                                      const int* bounds, const int* lbounds,
                                      int* mark, int* counts, int rows,
                                      int cap_a, int cap_b, void* stream) {
  return launch_expand<false>(PaddedRows{a, nullptr, rows, cap_a},
                              PaddedRows{b, nullptr, rows, cap_b}, bounds, lbounds, mark,
                              counts, rows, cap_a, cap_b, cap_a, stream);
}

// The INTER expand level: B's row i the neighbours of vb[i] cut at cap_b;
// A's row a's (a != NULL, (B, cap_a) padded) or the neighbours of va[i]
// cut at cap_a; rows (B, out_cap) and counts (B,) out.
extern "C" int repro_intersect_expand_csr(const int* indptr, const int* indices,
                                          const int* a, const int* va, const int* vb,
                                          const int* bounds, const int* lbounds,
                                          int* out_rows, int* counts, int rows,
                                          int cap_a, int cap_b, int out_cap,
                                          void* stream) {
  const CsrRows B{indptr, indices, nullptr, vb, rows, {cap_b}};
  if (a)
    return launch_expand<true>(PaddedRows{a, nullptr, rows, cap_a}, B, bounds, lbounds,
                               out_rows, counts, rows, cap_a, cap_b, out_cap, stream);
  return launch_expand<true>(CsrRows{indptr, indices, nullptr, va, rows, {cap_a}}, B,
                             bounds, lbounds, out_rows, counts, rows, cap_a, cap_b,
                             out_cap, stream);
}

// rows2 (B, out_cap), counts and offs (B,) in; src and verts (out_items,)
// out. counts[i] <= out_cap for every row.
extern "C" int repro_expand_items(const int* rows2, const int* counts, const int* offs,
                                  int* src, int* verts, int batch, int out_cap,
                                  int out_items, void* stream) {
  if (batch < 0 || out_cap < 1 || out_items < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (batch + kItemThreads / 32 - 1) / (kItemThreads / 32);
  int tail_blocks = (out_items / 4 + kItemThreads) / kItemThreads;
  tail_blocks = tail_blocks < kItemTailBlocks ? tail_blocks : kItemTailBlocks;
  expand_items_kernel<<<row_blocks + tail_blocks, kItemThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows2, counts, offs, src, verts, batch, out_cap, out_items, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_intersect_mark(const int* a, const int* b,
                                    const int* bounds, const int* lbounds,
                                    int* mark, int rows, int cap_a, int cap_b,
                                    void* stream) {
  const int caps[kMaxRefs] = {cap_b};
  return launch_level<MarkLane>(PaddedRows{a, nullptr, rows, cap_a},
                                PaddedRows{b, nullptr, rows, cap_b}, bounds, lbounds,
                                nullptr, nullptr, mark, nullptr, nullptr, rows, cap_a,
                                caps, 1, 1, 0, 0, stream);
}

// a (B, cap_a) padded; B's row i the neighbours of vb[i] cut at cap_b; sub
// 0 INTER, 1 SUB; mark (B, cap_a) 1-byte.
extern "C" int repro_intersect_mark_csr(const int* indptr, const int* indices,
                                        const int* a, const int* vb,
                                        const int* bounds, const int* lbounds,
                                        unsigned char* mark, int rows, int cap_a,
                                        int cap_b, int sub, void* stream) {
  const CsrRows B{indptr, indices, nullptr, vb, rows, {cap_b}};
  return launch_level<MarkLane>(PaddedRows{a, nullptr, rows, cap_a}, B, bounds,
                                lbounds, nullptr, nullptr, mark, nullptr, nullptr, rows,
                                cap_a, B.caps, 1, sub ? 0 : 1, 0, 0, stream);
}

// bs (k, B, cap_b); excludes (B, n_excl) or NULL with n_excl == 0; k <= 8.
extern "C" int repro_intersect_multi(const int* a, const int* bs,
                                     const int* bounds, const int* lbounds,
                                     const int* excludes, int* mark,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, int k, int n_inter,
                                     int n_excl, void* stream) {
  const int caps[kMaxRefs] = {cap_b, cap_b, cap_b, cap_b, cap_b, cap_b, cap_b, cap_b};
  return launch_level<MultiLane>(PaddedRows{a, nullptr, rows, cap_a},
                                 PaddedRows{bs, nullptr, rows, cap_b}, bounds, lbounds,
                                 excludes, nullptr, mark, counts, nullptr, rows, cap_a,
                                 caps, k, n_inter, n_excl, 0, stream);
}

// General levels: reference r of row i is the neighbour list of
// vbs[r * rows + i] cut at cap_r. With mark (1-byte, (B, cap_a)), A is the
// padded a and no counts are written; else counts, A the padded a or, when
// a is NULL, the neighbours of va[i] cut at cap_a.
extern "C" int repro_intersect_multi_csr(
    const int* indptr, const int* indices, const int* a, const int* va,
    const int* vbs, const int* bounds, const int* lbounds, const int* excludes,
    unsigned char* mark, int* counts, int rows, int cap_a, int k, int n_inter,
    int n_excl, int cap0, int cap1, int cap2, int cap3, int cap4, int cap5,
    int cap6, int cap7, void* stream) {
  const CsrRows Bs{indptr, indices, nullptr, vbs, rows,
                   {cap0, cap1, cap2, cap3, cap4, cap5, cap6, cap7}};
  const PaddedRows A{a, nullptr, rows, cap_a};
  if (mark)
    return launch_level<MultiLane>(A, Bs, bounds, lbounds, excludes, nullptr, mark,
                                   nullptr, nullptr, rows, cap_a, Bs.caps, k, n_inter,
                                   n_excl, 0, stream);
  void* none = nullptr;
  if (a)
    return launch_level<MultiLane>(A, Bs, bounds, lbounds, excludes, nullptr, none,
                                   counts, nullptr, rows, cap_a, Bs.caps, k, n_inter,
                                   n_excl, 0, stream);
  return launch_level<MultiLane>(CsrRows{indptr, indices, nullptr, va, rows, {cap_a}},
                                 Bs, bounds, lbounds, excludes, nullptr, none, counts,
                                 nullptr, rows, cap_a, Bs.caps, k, n_inter, n_excl, 0,
                                 stream);
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
  return launch_level<AggLane>(PaddedRows{a, a_vals, rows, cap_a},
                               PaddedRows{bs, b_vals, rows, cap_b}, bounds, lbounds,
                               excludes, scale, mark, counts, vals, rows, cap_a, caps, k,
                               n_inter, n_excl, op, stream);
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
  void* none = nullptr;
  if (a)
    return launch_level<AggLane>(PaddedRows{a, a_vals, rows, cap_a}, Bs, bounds,
                                 lbounds, excludes, scale, none, counts, vals, rows,
                                 cap_a, Bs.caps, k, n_inter, n_excl, op, stream);
  return launch_level<AggLane>(CsrRows{indptr, indices, edge_values, va, rows, {cap_a}},
                               Bs, bounds, lbounds, excludes, scale, none, counts, vals,
                               rows, cap_a, Bs.caps, k, n_inter, n_excl, op, stream);
}

// The general in-place count leaf: repro_intersect_multi_count_worklist. It
// replaces no TPU kernel: the JAX engine slices each chunk of a leaf out of
// its parent's worklist with XLA ops, and so did the engine here, with
// about fifteen PyTorch kernels around the k-reference count (the new
// vertex column, the live mask, one gather a forwarded column, the bound,
// the stacks of references and excludes, the int64 cast and the sum). This
// entry reads the worklist where the parent's expand left it. Item i of the
// chunk [lo, lo + m) has its vertex of column c at verts2[lo + i] when c is
// the parent's new vertex (vcol), else at col_c[src[lo + i]] (a column the
// parent forwards, its wave's (B,) ids). Its base row is rows2[src[lo + i],
// :cap_a] (base -1: the parent's carried survivors, WorklistRows) or the
// neighbours of column base's vertex cut at cap_a; its references are the
// neighbours of each column of the inter mask (INTER) and of the sub mask
// (SUB), column c cut at cap_c; its upper bound the least vertex of the ub
// mask's columns (SENTINEL when none), its lower bound the greatest of the
// lb mask's (-1 when none), and its excludes the vertices of the excl
// mask's columns. The counts of the m rows are summed into *total: the
// multi_csr count of the sliced chunk, summed.
//
// Bound: bytes, as the level kernel's: each item's base window and
// reference windows, 4 bytes of src and of each column it reads, 8 bytes
// written a block.
//
// Design: level_kernel's template with WorklistCsrRows (or WorklistRows)
// as A, WorklistCsrRows as the references, WorklistItems as the bounds and
// excludes, and SumInto as its output: the same warp-a-row and block-a-row
// paths, so the counts are the sliced leaf's. A row's excludes are read
// once into shared memory, as its team's first step; a block's rows sum in
// shared memory and thread 0 adds the block's total into the int64 with one
// 64-bit atomic: no per-row counts, no cast and no reduction launch.
extern "C" int repro_intersect_multi_count_worklist(
    const int* indptr, const int* indices, const int* rows2, const int* src,
    const int* verts2, const int* col0, const int* col1, const int* col2,
    const int* col3, const int* col4, const int* col5, const int* col6,
    const int* col7, long long* total, int lo, int m, int out_cap, int cap_a, int base,
    int vcol, int inter, int sub, int ub, int lb, int excl, int cap0, int cap1,
    int cap2, int cap3, int cap4, int cap5, int cap6, int cap7, void* stream) {
  const int* cols[kMaxCols] = {col0, col1, col2, col3, col4, col5, col6, col7};
  const int caps[kMaxCols] = {cap0, cap1, cap2, cap3, cap4, cap5, cap6, cap7};
  const int all = (1 << kMaxCols) - 1;
  if (lo < 0 || m < 0 || cap_a < 1 || vcol < 0 || vcol >= kMaxCols || base < -1 ||
      base >= kMaxCols || ((inter | sub | ub | lb | excl) & ~all) || (inter & sub) ||
      (base < 0 && (!rows2 || cap_a > out_cap)))
    return static_cast<int>(cudaErrorInvalidValue);
  // every column read is the new vertex or a forwarded column
  const int used = inter | sub | ub | lb | excl | (base >= 0 ? 1 << base : 0);
  for (int c = 0; c < kMaxCols; ++c)
    if ((used >> c & 1) && c != vcol && !cols[c]) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const WorklistIds ids{src + lo, verts2 + lo,
                        {col0, col1, col2, col3, col4, col5, col6, col7}, vcol};
  WorklistCsrRows Bs{indptr, indices, ids, {}, {}};
  int k = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int c = 0; c < kMaxCols; ++c)
      if ((pass ? sub : inter) >> c & 1) {
        if (k == kMaxRefs) return static_cast<int>(cudaErrorInvalidValue);
        Bs.col[k] = c;
        Bs.caps[k++] = caps[c];
      }
  const int n_inter = __builtin_popcount(static_cast<unsigned>(inter));
  WorklistItems items{ids, static_cast<unsigned>(ub), static_cast<unsigned>(lb), {}, 0};
  for (int c = 0; c < kMaxCols; ++c)
    if (excl >> c & 1) items.excl_col[items.n_excl++] = c;
  const SumInto out{reinterpret_cast<unsigned long long*>(total)};
  void* none = nullptr;
  if (base < 0)
    return launch_level_of<MultiLane>(WorklistRows{rows2, src + lo, out_cap, cap_a}, Bs,
                                      items, nullptr, none, out, nullptr, m, cap_a,
                                      Bs.caps, k, n_inter, 0, stream);
  return launch_level_of<MultiLane>(
      WorklistCsrRows{indptr, indices, ids, {base}, {cap_a}}, Bs, items, nullptr, none,
      out, nullptr, m, cap_a, Bs.caps, k, n_inter, 0, stream);
}
