"""Tensor-times-vector over CSF (paper §VI-I):  A_ij = Σ_k T_ijk · B_k.

The CSF last-mode fibres T(i,j,:) are (key, value) streams; TTV is one
batched S_VINTER of the fibres against the shared vector stream, block by
block of fibres as in the JAX package. The vector is one row on the device,
expanded (row stride 0) over each block: every fibre reads the same stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.stream import SENTINEL, round_capacity
from repro_torch.kernels.ops import xvinter


@dataclasses.dataclass(frozen=True)
class CSFTensor:
    """3-mode CSF: root mode i -> fibers (i,j) -> last-mode (k, val) streams."""

    i_ids: np.ndarray       # (F,) root coordinate per fiber
    j_ids: np.ndarray       # (F,) second coordinate per fiber
    fiber_ptr: np.ndarray   # (F+1,) into k_ids/vals
    k_ids: np.ndarray       # (nnz,) sorted within each fiber
    vals: np.ndarray        # (nnz,)
    shape: tuple[int, int, int]

    @property
    def nnz(self) -> int:
        return int(self.k_ids.shape[0])

    @property
    def num_fibers(self) -> int:
        return int(self.i_ids.shape[0])


def from_coo(coords: np.ndarray, values: np.ndarray,
             shape: tuple[int, int, int]) -> CSFTensor:
    order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    coords, values = coords[order], values[order]
    fiber_key = coords[:, 0].astype(np.int64) * shape[1] + coords[:, 1]
    uniq, starts = np.unique(fiber_key, return_index=True)
    fiber_ptr = np.concatenate([starts, [len(values)]]).astype(np.int64)
    return CSFTensor(
        i_ids=(uniq // shape[1]).astype(np.int32),
        j_ids=(uniq % shape[1]).astype(np.int32),
        fiber_ptr=fiber_ptr,
        k_ids=coords[:, 2].astype(np.int32),
        vals=values.astype(np.float32),
        shape=shape)


def random_csf(shape: tuple[int, int, int], nnz: int, seed: int = 0) -> CSFTensor:
    rng = np.random.default_rng(seed)
    flat = rng.choice(shape[0] * shape[1] * shape[2], size=nnz, replace=False)
    coords = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int64)
    return from_coo(coords, rng.normal(size=nnz).astype(np.float32), shape)


def ttv(t: CSFTensor, vec_keys: np.ndarray, vec_vals: np.ndarray,
        fiber_block: int = 512, device="cuda"):
    """A_ij = Σ_k T_ijk B_k with B a sparse vector (key, value) stream.

    Returns (i_ids, j_ids, values): the nonzero output matrix in COO.
    Dense B is the special case vec_keys = arange(K)."""
    cap_k = round_capacity(int(np.diff(t.fiber_ptr).max()) if t.num_fibers else 1)
    cap_v = round_capacity(len(vec_keys))
    vk = np.full((1, cap_v), SENTINEL, np.int32)
    vk[0, : len(vec_keys)] = vec_keys
    vv = np.zeros((1, cap_v), np.float32)
    vv[0, : len(vec_keys)] = vec_vals
    # every fibre as a padded row, built at once on the host
    lens = np.diff(t.fiber_ptr)
    fib = np.repeat(np.arange(t.num_fibers), lens)
    pos = np.arange(t.nnz) - np.repeat(t.fiber_ptr[:-1], lens)
    fk = np.full((t.num_fibers, cap_k), SENTINEL, np.int32)
    fv = np.zeros((t.num_fibers, cap_k), np.float32)
    fk[fib, pos] = t.k_ids
    fv[fib, pos] = t.vals
    fk, fv, vk, vv = (torch.from_numpy(x).to(device) for x in (fk, fv, vk, vv))
    out = torch.empty((t.num_fibers,), dtype=torch.float32, device=fk.device)
    for f0 in range(0, t.num_fibers, fiber_block):
        f1 = min(f0 + fiber_block, t.num_fibers)
        nb = f1 - f0
        out[f0:f1] = xvinter(fk[f0:f1], fv[f0:f1], vk.expand(nb, cap_v),
                             vv.expand(nb, cap_v))
    return t.i_ids, t.j_ids, out.cpu().numpy()
