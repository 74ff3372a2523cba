"""Value-plane lookups: per-(vertex, key) edge weights out of a weighted CSR.

The aggregate leaf (``mining.engine.WaveRunner._agg_body``) needs two
weight sources the membership kernel does not observe:

* **prefix-prefix edges**: pattern edges wholly inside the matched prefix
  (the (0, 1) feed edge among them). Their endpoints are per-item scalars,
  so the weight is one lookup per item, folded into the kernel's per-row
  ``scale`` operand (``prefix_scale``).
* **carry-covered candidate edges**: when a leaf reuses the parent's
  survivor stream, or has candidate-adjacent columns beyond its own INTER
  references, the membership that proved candidate ∈ N(v_c) was tested at
  an ancestor level; ``edge_value_lookup`` recovers its weight per (item,
  slot).

Both are one primitive: the lower bound of a key inside the source
vertex's CSR window [indptr[u], indptr[u+1]). The JAX package finds it by a
binary search with a step count fixed by the padded max degree; here one
``torch.searchsorted`` of ``u · 2^31 + key`` into the graph's sorted
``edge_keys`` finds the same index in a handful of ops (each torch op costs
the host a launch). A miss (key not adjacent, or SENTINEL padding) gives
0.0. Plain torch ops on either device, as the JAX package computes them
outside its kernels.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import CSRGraph

__all__ = ["edge_value_lookup", "prefix_scale"]


def edge_value_lookup(g: CSRGraph, us: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Weight of edge (us[i], keys[i, ...]) per element; 0.0 on a miss.

    ``us`` is (N,) int source vertices; ``keys`` is (N,) or (N, K) int32
    target keys (SENTINEL padding allowed). Returns f32 of ``keys``' shape.
    Every index into ``indices`` is clamped to its last slot, so no gather
    leaves the tensor (a CUDA gather out of range is a device assert).
    SENTINEL (2^31 - 1) sorts after every real key of u's window, so it
    lands on the window's end and misses.
    """
    if g.edge_values is None:
        raise ValueError("graph has no edge_values (see with_edge_values)")
    us = us.long()
    kk = (keys if keys.dim() == 2 else keys[:, None]).long()
    # lower bound in u's window: every key of an earlier vertex is smaller,
    # every key of a later one larger, so the result lies in [lo_u, hi_u]
    idx = torch.searchsorted(g.edge_keys, (us[:, None] << 31) + kk)
    win_hi = g.indptr[us + 1].long()[:, None]
    at = idx.clamp_(max=g.indices.shape[0] - 1)
    found = (at < win_hi) & (g.indices[at] == kk)
    out = torch.where(found, g.edge_values[at], 0.0)
    return out if keys.dim() == 2 else out[:, 0]


def prefix_scale(g: CSRGraph, get: dict, edges) -> torch.Tensor:
    """Per-item product of prefix-prefix pattern-edge weights.

    ``get`` maps prefix column -> (N,) matched-vertex vector; ``edges`` is
    the leaf's ``agg_scale_edges``. Empty ``edges`` give ones, the neutral
    scale operand."""
    cols = next(iter(get.values()))
    scale = torch.ones((cols.shape[0],), dtype=torch.float32, device=cols.device)
    for i, j in edges:
        scale = scale * edge_value_lookup(g, get[i], get[j])
    return scale
