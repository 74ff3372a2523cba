// Batched bounded sorted-row intersection for Hopper (sm_90a).
//
// Replaces the five Pallas kernels on the mining main path:
//   repro_intersect_count  <- repro/kernels/intersect.py:intersect_count_pallas
//                             (_count_kernel): counts (B,)
//   repro_intersect_expand <- repro/kernels/intersect.py:intersect_expand_pallas
//                             (_expand_kernel): mark (B, cap_a) and counts (B,)
//   repro_intersect_mark   <- repro/kernels/intersect.py:intersect_mark_pallas
//                             (_mark_kernel): mark (B, cap_a)
//   repro_intersect_multi  <- repro/kernels/intersect.py:intersect_multi_pallas
//                             (_multi_kernel): k-reference mark and counts,
//                             contract further down
//   repro_intersect_multi_agg <- repro/kernels/intersect.py:
//                             intersect_multi_agg_pallas (_multi_agg_kernel):
//                             the k-reference level with the SVPU value
//                             lane, contract at the end
//
// Contract (first three): rows of a (B, cap_a) and b (B, cap_b) are sorted int32
// sets padded with SENTINEL = 2^31-1. Slot s of row i counts iff
//   a[i,s] != SENTINEL, lbounds[i] < a[i,s] < bounds[i], a[i,s] in b[i,:].
// bounds == NULL means SENTINEL, lbounds == NULL means -1. Bound 0 kills a
// row (the engine folds padding and residual-failing items into it).
//
// Bound on an H100 SXM: the kernels move bytes, not operations. Each reads
// at most B*(cap_a+cap_b)*4 bytes of rows, and at least the keys inside each
// row's (lbound, bound) window, plus 8 bytes of bounds per row; it writes
// 4 bytes per row of counts and/or B*cap_a*4 of mark; all at 3.35 TB/s.
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
//     the staged window; expand and mark write the mark row in full (0
//     outside A's window) in the same pass;
//   * a warp-shuffle plus shared-memory block reduction gives the count
//     (count and expand; mark is the same template without it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kStageKeys = 8192;

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
constexpr int kMaxRefs = 8;

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
// k-reference level with the SVPU value lane: repro_intersect_multi_agg
//
// Contract: repro_intersect_multi's, plus a_vals (B, cap_a) f32, b_vals
// (k, B, cap_b) f32 aligned with bs (SUB refs' values are not read), scale
// (B,) f32 and op (0 sum, 1 max, 2 min). Kept slot s of row i carries
//   a_vals[i,s] * v_0 * v_1 * ... * scale[i],
// v_r the value beside a[i,s] in INTER ref r, multiplied in that order (the
// plain version's), so every product agrees bit for bit; vals[i] reduces
// the kept slots with op, and a row with none (bound 0 among them) gives
// 0.0f, -3.4e38f or +3.4e38f. The row reduction runs in double and rounds
// once to f32: a sum that f32 holds exactly comes out exact in any order.
//
// Bound: bytes, as repro_intersect_multi's, plus the values beside the
// window keys of A and of each INTER ref and the scale, read once, and 4
// bytes of vals a row written.
//
// Design: intersect_multi_kernel with values. A staged ref carries its
// values beside its keys (8 bytes a key, so the same 32 KB holds 4096
// keys), and a ref past that is read in global memory, keys and values;
// each thread's search returns the position of its key, where the value
// is read; thread partials reduce by warp shuffles, then across warps
// through shared memory.
constexpr int kAggStageKeys = 4096;
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

__global__ void intersect_multi_agg_kernel(
    const int* __restrict__ a, const int* __restrict__ bs,
    const int* __restrict__ bounds, const int* __restrict__ lbounds,
    const int* __restrict__ excludes, const float* __restrict__ a_vals,
    const float* __restrict__ b_vals, const float* __restrict__ scale,
    int* __restrict__ mark, int* __restrict__ counts,
    float* __restrict__ vals, int rows, int cap_a, int cap_b, int k,
    int n_inter, int n_excl, int stage_keys, int op) {
  extern __shared__ int staged[];         // keys [0, stage_keys), then values
  float* staged_vals = reinterpret_cast<float*>(staged + stage_keys);
  __shared__ int win[2 * kMaxRefs + 2];   // (lo, hi) per ref, then A's
  __shared__ int off[kMaxRefs];           // staged offset, -1: global
  __shared__ int warp_sums[32];
  __shared__ double warp_vals[32];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* __restrict__ arow = a + static_cast<size_t>(row) * cap_a;
  const int ub = bounds ? bounds[row] : kSentinel;
  const int lb = lbounds ? lbounds[row] : -1;
  const bool dead = static_cast<long long>(ub) <= static_cast<long long>(lb) + 1;

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
    const size_t at = (static_cast<size_t>(r) * rows + row) * cap_b + win[2 * r];
    const int nb = win[2 * r + 1] - win[2 * r];
    for (int i = tid; i < nb; i += blockDim.x) staged[off[r] + i] = bs[at + i];
    if (r < n_inter) {
      for (int i = tid; i < nb; i += blockDim.x)
        staged_vals[off[r] + i] = b_vals[at + i];
    }
  }
  __syncthreads();

  const int* __restrict__ erow =
      n_excl ? excludes + static_cast<size_t>(row) * n_excl : nullptr;
  const float* __restrict__ avrow = a_vals + static_cast<size_t>(row) * cap_a;
  int* __restrict__ mrow = mark + static_cast<size_t>(row) * cap_a;
  const float sc = scale[row];
  int kept_here = 0;
  double acc = agg_identity(op);
  for (int s = tid; s < cap_a; s += blockDim.x) {
    int keep = 0;
    if (s >= a_lo && s < a_hi) {
      const int key = arow[s];
      float v = avrow[s];
      keep = 1;
      for (int e = 0; e < n_excl && keep; ++e) keep = erow[e] != key;
      for (int r = 0; r < k && keep; ++r) {
        const int nb = win[2 * r + 1] - win[2 * r];
        const size_t at = (static_cast<size_t>(r) * rows + row) * cap_b + win[2 * r];
        const int* rw = off[r] >= 0 ? staged + off[r] : bs + at;
        const int p = lower_bound(rw, nb, key);
        const bool hit = p < nb && rw[p] == key;
        keep = hit == (r < n_inter);
        if (keep && r < n_inter)
          v = __fmul_rn(v, off[r] >= 0 ? staged_vals[off[r] + p] : b_vals[at + p]);
      }
      if (keep) acc = agg_combine(op, acc, static_cast<double>(__fmul_rn(v, sc)));
    }
    mrow[s] = keep;
    kept_here += keep;
  }
  block_sum_to(kept_here, warp_sums, counts + row);
  block_agg_to(acc, op, warp_vals, vals + row);
}

}  // namespace

extern "C" int repro_intersect_count(const int* a, const int* b,
                                     const int* bounds, const int* lbounds,
                                     int* counts, int rows, int cap_a,
                                     int cap_b, void* stream) {
  return launch<false, true>(a, b, bounds, lbounds, nullptr, counts, rows,
                             cap_a, cap_b, stream);
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
  if (k < 1 || k > kMaxRefs || n_inter < 0 || n_inter > k || n_excl < 0 ||
      op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cap_a >= 2048 ? 256 : 128;
  const int total = k * cap_b;
  const int stage_keys = total < kAggStageKeys ? total : kAggStageKeys;
  intersect_multi_agg_kernel<<<rows, threads,
                               stage_keys * (sizeof(int) + sizeof(float)),
                               static_cast<cudaStream_t>(stream)>>>(
      a, bs, bounds, lbounds, excludes, a_vals, b_vals, scale, mark, counts,
      vals, rows, cap_a, cap_b, k, n_inter, n_excl, stage_keys, op);
  return static_cast<int>(cudaGetLastError());
}
