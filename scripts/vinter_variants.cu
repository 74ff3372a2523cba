// S_VINTER designs that src/repro_torch/kernels/csrc/svinter.cu does not
// use, kept so that scripts/bench_vinter_variants.py can time them beside
// its kernels on the same inputs (same contract, same results):
//
//   exp_vinter variant 8, 16, 32 (short A rows, cap_a <= 128): teams of that
//     many lanes a pair; B's row staged in shared memory by cp.async
//     (rows.cuh:stage_async), once for the block when B has row stride 0;
//     B's live length from ballots over the staged words; one A key a lane
//     searched in the staged row, B's value read where it lies.
//   exp_vinter variant 1, 2, 3 (any cap_a): a warp a pair, four A keys a
//     lane searched in lockstep; B's row staged with its values (1) or its
//     keys alone (2), a slice a warp or one for the block at row stride 0,
//     or searched in device memory (3).
//   exp_vinter_grid variant 0, 1 (any caps): a block takes a tile of 2 A
//     rows x 4 B rows, a warp a pair, the rows read where they lie (0) or
//     staged with their values once for the block (1; the tile halved while
//     it overflows shared memory, up to the opt-in maximum).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/rows.cuh"

namespace {

constexpr int kPairWarps = 4;
constexpr int kBlock = 32 * kPairWarps;
constexpr int kGridRows = 2;
constexpr int kGridCols = 4;
constexpr int kStageBytes = 48 * 1024;

__device__ __forceinline__ float term(float x, float y, int op) {
  return op == 0 ? __fmul_rn(x, y) : (op == 1 ? fmaxf(x, y) : fminf(x, y));
}

__device__ __forceinline__ int live_length(const int* row, int n) {
  return warp_lower_bound(row, 0, n, kSentinel);
}

__device__ __forceinline__ double warp_sum(double acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// The terms of four A keys (SENTINEL: none) found in B's row bk[0, nb),
// B's values read from bv where found.
__device__ __forceinline__ double terms4(const int (&key)[4], const float (&va)[4],
                                         const int* bk, int nb, const float* bv, int op) {
  int pos[4];
  lower_bound4(bk, nb, key, pos);
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (key[j] != kSentinel && pos[j] < nb && bk[pos[j]] == key[j])
      acc += static_cast<double>(term(va[j], bv[pos[j]], op));
  return acc;
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

// Longer A rows, paired: pair = blockIdx.x * kPairWarps + warp. kStaged:
// B's keys (and with kVals its values) in shared memory, each warp's slice
// stage_words long (ldb != 0), else one slice for the block.
template <bool kStaged, bool kVals>
__global__ void __launch_bounds__(32 * kPairWarps)
vinter_kernel(const int* __restrict__ a_keys, const float* __restrict__ a_vals,
              const int* __restrict__ b_keys, const float* __restrict__ b_vals,
              float* __restrict__ out, int rows, int cap_a, int cap_b, long long ldb,
              int op, int stage_words) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * kPairWarps + warp;
  const bool live = pair < rows;
  const int* __restrict__ ak = a_keys + static_cast<size_t>(live ? pair : 0) * cap_a;
  const float* __restrict__ av = a_vals + static_cast<size_t>(live ? pair : 0) * cap_a;
  const int* bk = b_keys + (live ? pair : 0) * ldb;
  const float* bv = b_vals + (live ? pair : 0) * ldb;
  // A's first group in flight under B's staging
  int4 q;
  float4 v;
  load_group(ak, av, 4 * lane, cap_a, q, v);
  if constexpr (kStaged) {
    const bool shared_b = ldb == 0;    // one row for the block
    int* slice = smem + (shared_b ? 0 : warp * stage_words);
    const int rank = shared_b ? static_cast<int>(threadIdx.x) : lane;
    const int nlanes = shared_b ? 32 * kPairWarps : 32;
    if (shared_b || live) {
      const int* kp = stage_async(slice, bk, cap_b, rank, nlanes);
      if constexpr (kVals)
        bv = stage_async(reinterpret_cast<float*>(slice + stage_need(cap_b)), bv, cap_b,
                         rank, nlanes);
      bk = kp;
    }
    async_wait_all();
    if (shared_b) __syncthreads(); else __syncwarp();
  }
  if (!live) return;                   // whole warps; no barrier follows
  const int nb = live_length(bk, cap_b);
  double acc = 0.0;
  if (nb > 0) {
    for (int g0 = 0;; g0 += 128) {
      const int key[4] = {q.x, q.y, q.z, q.w};
      const float va[4] = {v.x, v.y, v.z, v.w};
      // A's first SENTINEL ends the row (sorted: a group's last key is
      // SENTINEL when any is); else the next group's loads go out before
      // this group's searches
      const bool last = __any_sync(kFull, q.w == kSentinel) || g0 + 128 >= cap_a;
      if (!last) load_group(ak, av, g0 + 128 + 4 * lane, cap_a, q, v);
      acc += terms4(key, va, bk, nb, bv, op);
      if (last) break;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[pair] = static_cast<float>(acc);
}

// Longer A rows, grid: block (bx, by) takes A rows [bx * tr, +tr) against
// B rows [by * tc, +tc), tr x tc <= 8 pairs, a warp a pair. kStaged: smem
// holds tr A slices of 2 * sa words (keys, then values) and tc B slices of
// 2 * sb words, then the tr + tc live lengths; else only the lengths, the
// rows read where they lie.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kGridRows * kGridCols)
vinter_grid_kernel(const int* __restrict__ a_keys, const float* __restrict__ a_vals,
                   const int* __restrict__ b_keys, const float* __restrict__ b_vals,
                   float* __restrict__ out, int nr, int nc, int cap_a, int cap_b,
                   int tr, int tc, int op) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kGridRows * kGridCols;
  const int r0 = blockIdx.x * tr, c0 = blockIdx.y * tc;
  const int ra = nr - r0 < tr ? nr - r0 : tr;
  const int cb = nc - c0 < tc ? nc - c0 : tc;
  const int sa = kStaged ? stage_need(cap_a) : 0, sb = kStaged ? stage_need(cap_b) : 0;
  int* lens = smem + 2 * (tr * sa + tc * sb);
  // row r of the tile (A rows first, then B rows): its keys and its values
  // where the block reads them
  auto keys_of = [&](int r) -> const int* {
    if constexpr (kStaged) {
      return r < ra ? smem + 2 * r * sa : smem + 2 * (tr * sa + (r - ra) * sb);
    } else {
      return r < ra ? a_keys + static_cast<size_t>(r0 + r) * cap_a
                    : b_keys + static_cast<size_t>(c0 + r - ra) * cap_b;
    }
  };
  auto vals_of = [&](int r) -> const float* {
    if constexpr (kStaged) {
      return reinterpret_cast<const float*>(keys_of(r) + (r < ra ? sa : sb));
    } else {
      return r < ra ? a_vals + static_cast<size_t>(r0 + r) * cap_a
                    : b_vals + static_cast<size_t>(c0 + r - ra) * cap_b;
    }
  };
  if constexpr (kStaged) {
    // rows start on 16-byte boundaries: each lands at its slice's start
    for (int r = warp; r < ra + cb; r += kWarps) {
      const size_t at = r < ra ? static_cast<size_t>(r0 + r) * cap_a
                               : static_cast<size_t>(c0 + r - ra) * cap_b;
      const int n = r < ra ? cap_a : cap_b;
      stage_async(const_cast<int*>(keys_of(r)), (r < ra ? a_keys : b_keys) + at, n, lane, 32);
      stage_async(const_cast<float*>(vals_of(r)), (r < ra ? a_vals : b_vals) + at, n, lane,
                  32);
    }
    async_wait_all();
    __syncthreads();
  }
  for (int r = warp; r < ra + cb; r += kWarps) {
    const int n = live_length(keys_of(r), r < ra ? cap_a : cap_b);
    if (lane == 0) lens[r] = n;
  }
  __syncthreads();
  if (warp >= ra * cb) return;         // a whole warp: no pair of this tile
  const int i = warp / cb, j = warp - i * cb;
  const int na = lens[i], nb = lens[ra + j];
  const int* ak = keys_of(i);
  const int* bk = keys_of(ra + j);
  const float* av = vals_of(i);
  const float* bv = vals_of(ra + j);
  double acc = 0.0;
  if (nb > 0) {
    for (int s0 = 4 * lane; s0 < na; s0 += 128) {
      const int4 q = *reinterpret_cast<const int4*>(ak + s0);
      const float4 v = *reinterpret_cast<const float4*>(av + s0);
      const int key[4] = {q.x, q.y, q.z, q.w};
      const float va[4] = {v.x, v.y, v.z, v.w};
      acc += terms4(key, va, bk, nb, bv, op);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[static_cast<size_t>(r0 + i) * nc + c0 + j] = static_cast<float>(acc);
}

// Shared memory a block may use on the current device (the opt-in maximum).
int smem_optin_bytes() {
  int dev = 0, bytes = kStageBytes;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <bool kStaged, bool kVals>
int launch_pairs(const int* ak, const float* av, const int* bk, const float* bv,
                 float* out, int rows, int cap_a, int cap_b, int ldb, int op,
                 int stage_words, size_t bytes, cudaStream_t s) {
  vinter_kernel<kStaged, kVals>
      <<<(rows + kPairWarps - 1) / kPairWarps, 32 * kPairWarps, bytes, s>>>(
          ak, av, bk, bv, out, rows, cap_a, cap_b, ldb, op, stage_words);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged>
int launch_grid(const int* ak, const float* av, const int* bk, const float* bv,
                float* out, int nr, int nc, int cap_a, int cap_b, int tr, int tc,
                int op, size_t bytes, cudaStream_t s) {
  if (bytes > kStageBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        vinter_grid_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nr + tr - 1) / tr, (nc + tc - 1) / tc);
  vinter_grid_kernel<kStaged><<<grid, 32 * kGridRows * kGridCols, bytes, s>>>(
      ak, av, bk, bv, out, nr, nc, cap_a, cap_b, tr, tc, op);
  return static_cast<int>(cudaGetLastError());
}


// Short A rows, teams of kTeam lanes: pair = blockIdx.x * (kBlock / kTeam) +
// team. smem: a slice of stage_words words a team, or one for the block
// (ldb == 0).
template <int kTeam>
__global__ void __launch_bounds__(kBlock)
team_kernel(const int* __restrict__ a_keys, const float* __restrict__ a_vals,
            const int* __restrict__ b_keys, const float* __restrict__ b_vals,
            float* __restrict__ out, int rows, int cap_a, int cap_b, long long ldb, int op,
            int stage_words) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x % kTeam;
  const int team = threadIdx.x / kTeam;
  const unsigned mask =
      kTeam == 32 ? kFull : ((1u << kTeam) - 1) << ((threadIdx.x & 31) & ~(kTeam - 1));
  const int pair = blockIdx.x * (kBlock / kTeam) + team;
  const bool live = pair < rows;
  const bool shared_b = ldb == 0;
  const int* __restrict__ ak = a_keys + static_cast<size_t>(live ? pair : 0) * cap_a;
  const float* __restrict__ av = a_vals + static_cast<size_t>(live ? pair : 0) * cap_a;
  const int* bk = b_keys + (live ? pair : 0) * ldb;
  const float* __restrict__ bv = b_vals + (live ? pair : 0) * ldb;
  int key = live && t < cap_a ? ak[t] : kSentinel;   // in flight under B's staging
  if (shared_b || live)
    bk = stage_async(smem + (shared_b ? 0 : team * stage_words), bk, cap_b,
                     shared_b ? static_cast<int>(threadIdx.x) : t, shared_b ? kBlock : kTeam);
  async_wait_all();
  __syncthreads();
  if (!live) return;                   // whole teams; no barrier follows
  int nb = 0;
  for (int w0 = 0; w0 < cap_b; w0 += kTeam) {
    const int w = w0 + t;
    const unsigned dead = __ballot_sync(mask, w >= cap_b || bk[w] == kSentinel) & mask;
    if (dead) {                        // sorted: the first SENTINEL ends the row
      nb = w0 + __ffs(dead) - 1 - ((threadIdx.x & 31) & ~(kTeam - 1));
      break;
    }
    nb = w0 + kTeam;
  }
  double acc = 0.0;
  for (int s = t;; s += kTeam) {
    const int cur = key;
    const bool last = (__ballot_sync(mask, cur == kSentinel) & mask) || s - t + kTeam >= cap_a;
    if (!last) key = s + kTeam < cap_a ? ak[s + kTeam] : kSentinel;
    if (cur != kSentinel) {
      const int p = lower_bound(bk, nb, cur);
      if (p < nb && bk[p] == cur) acc += static_cast<double>(term(av[s], bv[p], op));
    }
    if (last) break;
  }
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(mask, acc, off);
  if (t == 0) out[pair] = static_cast<float>(acc);
}

template <int kTeam>
int launch_team(const int* ak, const float* av, const int* bk, const float* bv, float* out,
                int rows, int cap_a, int cap_b, int ldb, int op, cudaStream_t s) {
  constexpr int teams = kBlock / kTeam;
  const int words = stage_need(cap_b);
  const size_t bytes = static_cast<size_t>(ldb == 0 ? 1 : teams) * words * sizeof(int);
  if (bytes > kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  team_kernel<kTeam><<<(rows + teams - 1) / teams, kBlock, bytes, s>>>(
      ak, av, bk, bv, out, rows, cap_a, cap_b, ldb, op, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As repro_vinter, by the design `variant` names (see the top of the file).
extern "C" int exp_vinter(const int* a_keys, const float* a_vals, const int* b_keys,
                          const float* b_vals, float* out, int rows, int cap_a, int cap_b,
                          int ldb, int op, int variant, void* stream) {
  if (op < 0 || op > 2 || ldb < 0 || rows <= 0 || cap_a < 4 || cap_a % 4 || cap_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = stage_need(cap_b);
  const size_t bytes = static_cast<size_t>(ldb == 0 ? 1 : kPairWarps) * need * sizeof(int);
  switch (variant) {
    case 8: return launch_team<8>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a, cap_b,
                                  ldb, op, s);
    case 16: return launch_team<16>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a,
                                    cap_b, ldb, op, s);
    case 32: return launch_team<32>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a,
                                    cap_b, ldb, op, s);
    case 1:
      if (2 * bytes > kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
      return launch_pairs<true, true>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a,
                                      cap_b, ldb, op, 2 * need, 2 * bytes, s);
    case 2:
      if (bytes > kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
      return launch_pairs<true, false>(a_keys, a_vals, b_keys, b_vals, out, rows, cap_a,
                                       cap_b, ldb, op, need, bytes, s);
    case 3: return launch_pairs<false, false>(a_keys, a_vals, b_keys, b_vals, out, rows,
                                              cap_a, cap_b, ldb, op, 0, 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As repro_vinter_grid, by the design `variant` names.
extern "C" int exp_vinter_grid(const int* a_keys, const float* a_vals, const int* b_keys,
                               const float* b_vals, float* out, int nr, int nc, int cap_a,
                               int cap_b, int op, int variant, void* stream) {
  if (op < 0 || op > 2 || nr <= 0 || nc <= 0 || cap_a < 4 || cap_a % 4 || cap_b < 4 ||
      cap_b % 4 || variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tr = kGridRows, tc = kGridCols;
  const int sa = stage_need(cap_a), sb = stage_need(cap_b);
  auto bytes_for = [&](int r, int c) {
    return static_cast<size_t>(2 * (r * sa + c * sb) + r + c) * sizeof(int);
  };
  if (variant == 1) {
    const size_t limit = bytes_for(tr, tc) <= kStageBytes
                             ? kStageBytes : static_cast<size_t>(smem_optin_bytes());
    while ((tr > 1 || tc > 1) && bytes_for(tr, tc) > limit) {
      if (tc >= tr) tc /= 2; else tr /= 2;
    }
    if (bytes_for(tr, tc) > limit) return static_cast<int>(cudaErrorInvalidValue);
  }
  tr = tr < nr ? tr : nr;
  tc = tc < nc ? tc : nc;
  if (variant == 1)
    return launch_grid<true>(a_keys, a_vals, b_keys, b_vals, out, nr, nc, cap_a, cap_b, tr,
                             tc, op, bytes_for(tr, tc), s);
  return launch_grid<false>(a_keys, a_vals, b_keys, b_vals, out, nr, nc, cap_a, cap_b, tr,
                            tc, op, static_cast<size_t>(tr + tc) * sizeof(int), s);
}
