"""InHouseAutoMine — the paper's scalar CPU baseline (§VI, footnote 1).

Scalar pattern enumeration with the engine's schedules and symmetry
breaking, run as ordinary CPU code: python loops over vertices and
``np.intersect1d``/``searchsorted`` per intersection. ``launch.mine
--baseline`` checks the engine's count against it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def _adj(g: CSRGraph):
    return g.indptr.cpu().numpy(), g.indices.cpu().numpy()


def _nbrs(indptr, indices, v) -> np.ndarray:
    return indices[indptr[v]: indptr[v + 1]]


def triangle_count(g: CSRGraph) -> int:
    indptr, indices = _adj(g)
    offsets = g.offsets.cpu().numpy()
    total = 0
    for v0 in range(g.num_vertices):
        n0 = _nbrs(indptr, indices, v0)
        for v1 in n0[: offsets[v0]]:                    # v1 < v0
            n1 = _nbrs(indptr, indices, v1)
            common = np.intersect1d(n0, n1, assume_unique=True)
            total += int(np.searchsorted(common, v1))   # bounded: v2 < v1
    return total


def clique_count(g: CSRGraph, k: int) -> int:
    if k == 3:
        return triangle_count(g)
    indptr, indices = _adj(g)
    offsets = g.offsets.cpu().numpy()
    total = 0

    def rec(prefix_set: np.ndarray, level: int) -> int:
        if level == k:
            return prefix_set.shape[0]
        c = 0
        for v in prefix_set:
            nv = _nbrs(indptr, indices, v)
            nxt = np.intersect1d(prefix_set, nv, assume_unique=True)
            nxt = nxt[: np.searchsorted(nxt, v)]        # bound: < v
            if level + 1 == k:
                c += nxt.shape[0]
            elif nxt.shape[0]:
                c += rec(nxt, level + 1)
        return c

    for v0 in range(g.num_vertices):
        n0 = _nbrs(indptr, indices, v0)
        for v1 in n0[: offsets[v0]]:
            n1 = _nbrs(indptr, indices, v1)
            s2 = np.intersect1d(n0, n1, assume_unique=True)
            s2 = s2[: np.searchsorted(s2, v1)]
            if s2.shape[0]:
                total += rec(s2, 3) if k > 3 else s2.shape[0]
    return total


def three_chain_count(g: CSRGraph, induced: bool = False) -> int:
    indptr, indices = _adj(g)
    deg = g.degrees.cpu().numpy().astype(np.int64)
    if not induced:
        return int((deg * (deg - 1) // 2).sum())
    total = 0
    for m in range(g.num_vertices):
        nm = _nbrs(indptr, indices, m)
        for a in nm:
            na = _nbrs(indptr, indices, a)
            rest = np.setdiff1d(nm, na, assume_unique=True)
            total += int(rest.shape[0] - np.searchsorted(rest, a, side="right"))
    return total


def tailed_triangle_count(g: CSRGraph) -> int:
    indptr, indices = _adj(g)
    deg = g.degrees.cpu().numpy().astype(np.int64)
    total = 0
    for v0 in range(g.num_vertices):
        n0 = _nbrs(indptr, indices, v0)
        for v1 in n0:
            n1 = _nbrs(indptr, indices, v1)
            common = np.intersect1d(n0, n1, assume_unique=True)
            c = int(np.searchsorted(common, v0))        # v2 < v0
            total += c * int(deg[v1] - 2)
    return total


def three_motif(g: CSRGraph) -> dict[str, int]:
    return {"triangle": triangle_count(g),
            "chain": three_chain_count(g, induced=True)}
