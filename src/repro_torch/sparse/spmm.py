"""Sparse x sparse matrix multiplication via S_VINTER (paper §VI-I).

The paper converts B to CSC and computes C[i,j] = S_VINTER(row_i(A),
col_j(B), MAC): every output element is one sparse dot of two (key, value)
streams. The dots are batched as in the JAX package: a row block of A
against a column block of B forms an (RB x CB) grid of stream pairs
evaluated in one kernel launch. Rows and columns with no entry are skipped
(the paper's dependency bound |A ∩ B| <= min lengths, used to elide work).

The padded rows of A and columns of B go to the device once; each block's
kernel (``ops.xvinter_grid``) reads the block's rows and columns as they lie
and evaluates every pair of them, so no pair's streams are copied, and the
output block stays on the device until one copy back at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import xvinter_grid

from .matrix import SparseCSC, SparseCSR


def spmsp_matmul(a: SparseCSR, b: SparseCSC, row_block: int = 64,
                 col_block: int = 64, device="cuda") -> np.ndarray:
    """C = A @ B, A in CSR, B in CSC; returns dense (M, N) float32."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    out = np.zeros((m, n), np.float32)
    rows_alive = np.nonzero(np.diff(a.indptr) > 0)[0]
    cols_alive = np.nonzero(np.diff(b.indptr) > 0)[0]
    if rows_alive.size == 0 or cols_alive.size == 0:
        return out
    ak, av, bk, bv = (torch.from_numpy(x).to(device)
                      for x in (*a.padded_rows(rows_alive), *b.padded_rows(cols_alive)))
    c = torch.empty((rows_alive.size, cols_alive.size), dtype=torch.float32,
                    device=ak.device)
    for r0 in range(0, rows_alive.size, row_block):
        rk, rv = ak[r0: r0 + row_block], av[r0: r0 + row_block]
        for c0 in range(0, cols_alive.size, col_block):
            ck, cv = bk[c0: c0 + col_block], bv[c0: c0 + col_block]
            c[r0: r0 + rk.shape[0], c0: c0 + ck.shape[0]] = xvinter_grid(rk, rv, ck, cv)
    out[np.ix_(rows_alive, cols_alive)] = c.cpu().numpy()
    return out
