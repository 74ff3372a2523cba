// Batched S_VINTER for Hopper (sm_90a).
//
// Replaces repro/kernels/svinter.py:vinter_pallas (_vinter_kernel):
//   repro_vinter: out[i] = sum over k in A_i ∩ B_i of op(va, vb),
//                 op 0 mac (va * vb), 1 max, 2 min.
//
// Contract: a_keys (B, cap_a) int32 and a_vals (B, cap_a) f32, rows
// contiguous; b_keys and b_vals (B, cap_b) with a row stride ldb in
// elements (0: every row reads the same stream, the TTV vector broadcast
// over the fibres). Key rows are sorted sets padded with SENTINEL =
// 2^31-1; a SENTINEL slot of A never counts. Unbounded. Each term is
// rounded to f32 as the plain version's is, then summed in double and
// rounded once to f32.
//
// Bound on an H100 SXM: bytes. The least read is the live keys and values
// of A and of B (8 bytes a slot) and the write 4 bytes a row, at 3.35 TB/s;
// the compare work, ~log2 |B_i| per live A key, is far below the integer
// rate.
//
// Design (simple first; the TPU kernel's tile compare and mask-MAC on the
// MXU, all-pairs over 128 x 128 tiles, is not carried over): one warp per
// row pair, since spmm's and ttv's rows hold 128-256 keys. The warp finds
// B's live length by its 32-way search for SENTINEL; each lane takes A's
// slots lane, lane + 32, ... up to A's first SENTINEL and binary-searches
// B's live keys in global memory (a row of 256 keys stays in L1); a warp
// shuffle sums the lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void vinter_kernel(const int* __restrict__ a_keys,
                              const float* __restrict__ a_vals,
                              const int* __restrict__ b_keys,
                              const float* __restrict__ b_vals,
                              float* __restrict__ out, int rows, int cap_a,
                              int cap_b, long long ldb, int op) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;   // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int* __restrict__ ak = a_keys + static_cast<size_t>(row) * cap_a;
  const float* __restrict__ av = a_vals + static_cast<size_t>(row) * cap_a;
  const int* __restrict__ bk = b_keys + row * ldb;
  const float* __restrict__ bv = b_vals + row * ldb;
  const int nb = warp_lower_bound(bk, 0, cap_b, kSentinel);
  double acc = 0.0;
  for (int s = lane; s < cap_a; s += 32) {
    const int key = ak[s];
    if (key == kSentinel) break;
    const int p = lower_bound(bk, nb, key);
    if (p < nb && bk[p] == key) {
      const float x = av[s], y = bv[p];
      const float t = op == 0 ? __fmul_rn(x, y) : (op == 1 ? fmaxf(x, y)
                                                           : fminf(x, y));
      acc += static_cast<double>(t);
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) out[row] = static_cast<float>(acc);
}

}  // namespace

// a_keys/a_vals (B, cap_a) contiguous; b_keys/b_vals (B, cap_b) with row
// stride ldb (0 allowed); out (B,) f32; op 0 mac, 1 max, 2 min.
extern "C" int repro_vinter(const int* a_keys, const float* a_vals,
                            const int* b_keys, const float* b_vals,
                            float* out, int rows, int cap_a, int cap_b,
                            int ldb, int op, void* stream) {
  if (op < 0 || op > 2 || ldb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  vinter_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      a_keys, a_vals, b_keys, b_vals, out, rows, cap_a, cap_b, ldb, op);
  return static_cast<int>(cudaGetLastError());
}
