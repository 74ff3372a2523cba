// Batched S_VINTER for Hopper (sm_90a).
//
// Replaces repro/kernels/svinter.py:vinter_pallas (_vinter_kernel):
//   repro_vinter:      out[i] = sum over k in A_i ∩ B_i of op(va, vb),
//                      op 0 mac (va * vb), 1 max, 2 min (the TPU contract:
//                      a batch of row pairs);
//   repro_vinter_grid: out[i, j] = the same over A row i and B row j, for
//                      every pair of two stacks (spmm's row block against
//                      its column block), no pair's rows copied.
//
// Contract: a_keys (B, cap_a) int32 and a_vals (B, cap_a) f32, rows
// contiguous on a 16-byte boundary, cap_a a multiple of 4; b_keys and
// b_vals (B, cap_b) with a row stride ldb in elements (0: every row reads
// the same stream, the TTV vector broadcast over the fibres). The grid
// form: a (nr, cap_a) as A above, b (nc, cap_b) contiguous; out (nr, nc)
// row-major. Key rows are sorted sets padded with SENTINEL = 2^31-1; a
// SENTINEL slot of A never counts. Unbounded. Each term is rounded to f32
// as the plain version's is, then summed in double and rounded once to f32.
//
// Bound on an H100 SXM: bytes or compares. The least read is the live keys
// and values of A and of B (8 bytes a slot; in the grid form each row
// once, not once a pair) and the write 4 bytes a result, at 3.35 TB/s; the
// compares are ~log2 |B_j| per live A key per pair, at the integer rate.
//
// Design (the TPU kernel's tile compare and mask-MAC on the MXU, all-pairs
// over 128 x 128 tiles, is not carried over). A warp takes a pair, in
// both forms: the grid form's pair p is A row p / nc against B row p % nc
// (a block's warps share A's row through L1). B's row is searched where it
// lies in device memory. scripts/bench_vinter_variants.py times the designs
// left out beside these kernels: at spmm's and ttv's rows (cap 128, every
// launch of the port) staging B in shared memory (for teams of 8, 16 or 32
// lanes a pair, or a warp's four keys a lane) and a grid tile of 2 A x 4 B
// rows were no faster; at rows of cap 2048, which no path of the port
// gives, staging B's keys and a staged grid tile were faster. A row's live
// length is its first SENTINEL, found by a warp's 32-way search
// (rows.cuh:warp_lower_bound); A's row ends at its first SENTINEL, seen by
// a ballot; the lanes sum their terms by shuffles.
//   * Short A rows (cap_a <= 128: ttv's fibres, spmm's rows and columns):
//     one A key a lane, 32 a round, each searched in B's row; the next
//     round's keys load under this round's searches.
//   * Longer A rows: each lane takes four consecutive A keys (one 16-byte
//     load, the values beside them; the next group's loads go out before
//     this group's searches) and searches them in lockstep (lower_bound4).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kPairWarps = 4;        // a block: 4 warps, a pair a warp
constexpr int kShortCap = 128;       // short A rows: one key a lane

__device__ __forceinline__ float term(float x, float y, int op) {
  return op == 0 ? __fmul_rn(x, y) : (op == 1 ? fmaxf(x, y) : fminf(x, y));
}

__device__ __forceinline__ double warp_sum(double acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// A pair's rows: kGrid, pair p is A row p / nc against B row p % nc (B
// contiguous, out (nr, nc) row-major, so out[p]); else A row p against B
// row p at row stride ldb. Offsets in elements.
template <bool kGrid>
__device__ __forceinline__ void pair_rows(int pair, int nc, int cap_a, int cap_b,
                                          long long ldb, long long& ao, long long& bo) {
  const int i = kGrid ? pair / nc : pair;
  ao = static_cast<long long>(i) * cap_a;
  bo = kGrid ? static_cast<long long>(pair - i * nc) * cap_b : pair * ldb;
}

// Short A rows: pair = blockIdx.x * kPairWarps + warp.
template <bool kGrid>
__global__ void __launch_bounds__(32 * kPairWarps)
vinter_short_kernel(const int* __restrict__ a_keys, const float* __restrict__ a_vals,
                    const int* __restrict__ b_keys, const float* __restrict__ b_vals,
                    float* __restrict__ out, int rows, int cap_a, int cap_b,
                    long long ldb, int nc, int op) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (pair >= rows) return;            // a whole warp
  long long ao, bo;
  pair_rows<kGrid>(pair, nc, cap_a, cap_b, ldb, ao, bo);
  const int* __restrict__ ak = a_keys + ao;
  const float* __restrict__ av = a_vals + ao;
  const int* __restrict__ bk = b_keys + bo;
  const float* __restrict__ bv = b_vals + bo;
  int key = lane < cap_a ? ak[lane] : kSentinel;   // in flight under B's search
  const int nb = warp_lower_bound(bk, 0, cap_b, kSentinel);
  double acc = 0.0;
  for (int s = lane;; s += 32) {
    const int cur = key;
    // A's first SENTINEL ends the row
    const bool last = __any_sync(kFull, cur == kSentinel) || s - lane + 32 >= cap_a;
    if (!last) key = s + 32 < cap_a ? ak[s + 32] : kSentinel;
    if (cur != kSentinel) {
      const int p = lower_bound(bk, nb, cur);
      if (p < nb && bk[p] == cur) acc += static_cast<double>(term(av[s], bv[p], op));
    }
    if (last) break;
  }
  acc = warp_sum(acc);
  if (lane == 0) out[pair] = static_cast<float>(acc);
}

// A's four keys and values at slot s0 (SENTINEL and 0 at or past cap_a;
// cap_a % 4 == 0, so s0 < cap_a covers the whole group): 16-byte loads.
__device__ __forceinline__ void load_group(const int* __restrict__ ak,
                                           const float* __restrict__ av, int s0,
                                           int cap_a, int4& q, float4& v) {
  if (s0 < cap_a) {
    q = *reinterpret_cast<const int4*>(ak + s0);
    v = *reinterpret_cast<const float4*>(av + s0);
  } else {
    q = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
    v = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Longer A rows: pair = blockIdx.x * kPairWarps + warp, four A keys a lane.
template <bool kGrid>
__global__ void __launch_bounds__(32 * kPairWarps)
vinter_kernel(const int* __restrict__ a_keys, const float* __restrict__ a_vals,
              const int* __restrict__ b_keys, const float* __restrict__ b_vals,
              float* __restrict__ out, int rows, int cap_a, int cap_b, long long ldb,
              int nc, int op) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (pair >= rows) return;            // a whole warp
  long long ao, bo;
  pair_rows<kGrid>(pair, nc, cap_a, cap_b, ldb, ao, bo);
  const int* __restrict__ ak = a_keys + ao;
  const float* __restrict__ av = a_vals + ao;
  const int* __restrict__ bk = b_keys + bo;
  const float* __restrict__ bv = b_vals + bo;
  // A's first group in flight under B's length search
  int4 q;
  float4 v;
  load_group(ak, av, 4 * lane, cap_a, q, v);
  const int nb = warp_lower_bound(bk, 0, cap_b, kSentinel);
  double acc = 0.0;
  for (int g0 = 0; nb > 0; g0 += 128) {
    const int key[4] = {q.x, q.y, q.z, q.w};
    const float va[4] = {v.x, v.y, v.z, v.w};
    // A's first SENTINEL ends the row (sorted: a group's last key is
    // SENTINEL when any is); else the next group's loads go out before
    // this group's searches
    const bool last = __any_sync(kFull, q.w == kSentinel) || g0 + 128 >= cap_a;
    if (!last) load_group(ak, av, g0 + 128 + 4 * lane, cap_a, q, v);
    int pos[4];
    lower_bound4(bk, nb, key, pos);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (key[j] != kSentinel && pos[j] < nb && bk[pos[j]] == key[j])
        acc += static_cast<double>(term(va[j], bv[pos[j]], op));
    if (last) break;
  }
  acc = warp_sum(acc);
  if (lane == 0) out[pair] = static_cast<float>(acc);
}

template <bool kGrid>
int launch_pairs(const int* ak, const float* av, const int* bk, const float* bv,
                 float* out, int pairs, int cap_a, int cap_b, long long ldb, int nc,
                 int op, cudaStream_t s) {
  const int blocks = (pairs + kPairWarps - 1) / kPairWarps;
  if (cap_a <= kShortCap)
    vinter_short_kernel<kGrid><<<blocks, 32 * kPairWarps, 0, s>>>(
        ak, av, bk, bv, out, pairs, cap_a, cap_b, ldb, nc, op);
  else
    vinter_kernel<kGrid><<<blocks, 32 * kPairWarps, 0, s>>>(ak, av, bk, bv, out, pairs,
                                                           cap_a, cap_b, ldb, nc, op);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a_keys/a_vals (B, cap_a) contiguous; b_keys/b_vals (B, cap_b) with row
// stride ldb (0 allowed); out (B,) f32; op 0 mac, 1 max, 2 min.
extern "C" int repro_vinter(const int* a_keys, const float* a_vals,
                            const int* b_keys, const float* b_vals,
                            float* out, int rows, int cap_a, int cap_b,
                            int ldb, int op, void* stream) {
  if (op < 0 || op > 2 || ldb < 0 || rows < 0 || cap_a < 4 || cap_a % 4 || cap_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a_keys) || !aligned16(a_vals))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return 0;
  return launch_pairs<false>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a, cap_b, ldb,
                             1, op, static_cast<cudaStream_t>(stream));
}

// a_keys/a_vals (nr, cap_a), b_keys/b_vals (nc, cap_b), contiguous; out
// (nr, nc) f32; op 0 mac, 1 max, 2 min.
extern "C" int repro_vinter_grid(const int* a_keys, const float* a_vals,
                                 const int* b_keys, const float* b_vals, float* out,
                                 int nr, int nc, int cap_a, int cap_b, int op,
                                 void* stream) {
  if (op < 0 || op > 2 || nr < 0 || nc < 0 || cap_a < 4 || cap_a % 4 || cap_b < 1 ||
      static_cast<long long>(nr) * nc > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a_keys) || !aligned16(a_vals))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (nr == 0 || nc == 0) return 0;
  return launch_pairs<true>(a_keys, a_vals, b_keys, b_vals, out, nr * nc, cap_a, cap_b, 0,
                            nc, op, static_cast<cudaStream_t>(stream));
}
