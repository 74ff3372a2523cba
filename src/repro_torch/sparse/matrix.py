"""Sparse matrix containers for the S_VINTER applications (§VI-I).

Rows (CSR) / columns (CSC) are exactly the paper's (key,value) streams:
sorted index keys plus aligned values. ``padded_rows`` materialises a batch
of them as LANE-padded matrices for the batched SVPU ops.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.stream import SENTINEL, round_capacity


@dataclasses.dataclass(frozen=True)
class SparseCSR:
    indptr: np.ndarray   # (M+1,)
    indices: np.ndarray  # (nnz,) column keys, sorted per row
    values: np.ndarray   # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def max_row_nnz(self) -> int:
        return int(np.diff(self.indptr).max()) if self.shape[0] else 0

    def padded_rows(self, rows: np.ndarray, cap: int | None = None):
        """(keys, vals) LANE-padded matrices for a batch of row ids."""
        cap = round_capacity(cap or self.max_row_nnz())
        keys = np.full((len(rows), cap), SENTINEL, np.int32)
        vals = np.zeros((len(rows), cap), np.float32)
        for i, r in enumerate(rows):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            n = min(hi - lo, cap)
            keys[i, :n] = self.indices[lo: lo + n]
            vals[i, :n] = self.values[lo: lo + n]
        return keys, vals

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        for r in range(self.shape[0]):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            out[r, self.indices[lo:hi]] = self.values[lo:hi]
        return out


class SparseCSC(SparseCSR):
    """CSC is CSR of the transpose: indptr over columns, keys are row ids."""

    @property
    def shape_t(self) -> tuple[int, int]:
        return (self.shape[1], self.shape[0])


def from_dense(a: np.ndarray, fmt: str = "csr") -> SparseCSR:
    a = np.asarray(a, np.float32)
    if fmt == "csc":
        t = from_dense(a.T, "csr")
        return SparseCSC(t.indptr, t.indices, t.values, a.shape)
    m, n = a.shape
    indptr = np.zeros(m + 1, np.int64)
    idx, val = [], []
    for r in range(m):
        cols = np.nonzero(a[r])[0]
        indptr[r + 1] = indptr[r] + len(cols)
        idx.append(cols)
        val.append(a[r, cols])
    return SparseCSR(indptr,
                     np.concatenate(idx).astype(np.int32) if idx else np.zeros(0, np.int32),
                     np.concatenate(val).astype(np.float32) if val else np.zeros(0, np.float32),
                     (m, n))


def random_sparse(m: int, n: int, density: float, seed: int = 0,
                  fmt: str = "csr") -> SparseCSR:
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    a = np.where(mask, rng.normal(size=(m, n)).astype(np.float32), 0.0)
    return from_dense(a, fmt)
