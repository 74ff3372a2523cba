"""Deterministic synthetic graph generators (offline stand-ins for Table IV).

The container has no network access, so the paper's ten real graphs are
replaced by deterministic generators parameterised to match each dataset's
(#V, #E, degree skew) — see ``datasets.py``. All generators take an explicit
seed and return a host edge array for ``build_csr``.
"""
from __future__ import annotations

import numpy as np


def edge_weights(edges: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic symmetric edge weights for a host edge array.

    Weight of {u, v} is a pure function of (min(u,v), max(u,v), seed) —
    identical no matter which direction or duplicate of the edge is asked,
    so weights survive ``build_csr``'s mirror/dedup untouched. Values are
    dyadic rationals in {0.25, 0.5, 0.75, 1.0}: products over a pattern's
    edges and small-graph sums stay exactly representable in f32, which is
    what lets the CI gate demand engine == oracle bit-for-bit.
    """
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    h = (lo * np.int64(0x9E3779B1) + hi * np.int64(0x85EBCA77)
         + np.int64(seed) * np.int64(0xC2B2AE3D)) & np.int64(0x7FFFFFFF)
    h ^= h >> 15
    return ((1 + (h & 3)).astype(np.float32)) * np.float32(0.25)


def erdos_renyi(n: int, m: int, seed: int = 0) -> np.ndarray:
    """~m undirected edges sampled uniformly (G(n, m) without replacement)."""
    rng = np.random.default_rng(seed)
    # over-sample then dedup; expected duplicates are tiny for sparse graphs
    k = int(m * 1.3) + 16
    src = rng.integers(0, n, size=k, dtype=np.int64)
    dst = rng.integers(0, n, size=k, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    key = lo * n + hi
    _, uniq = np.unique(key, return_index=True)
    uniq = uniq[:m]
    return np.stack([lo[uniq], hi[uniq]], axis=1)


def powerlaw_cluster(n: int, m_per_node: int, seed: int = 0,
                     tri_p: float = 0.3) -> np.ndarray:
    """Holme–Kim style preferential attachment with triangle closure.

    Produces the heavy-tailed degree distributions of the paper's social
    graphs (wiki-vote, livejournal, youtube) and non-trivial triangle counts.
    Vectorised preferential attachment via the repeated-endpoint trick.
    """
    rng = np.random.default_rng(seed)
    m_per_node = max(1, m_per_node)
    targets = list(range(m_per_node))
    repeated: list[int] = list(range(m_per_node))
    edges = []
    for v in range(m_per_node, n):
        chosen = rng.choice(len(repeated), size=m_per_node, replace=False)
        vs = {repeated[c] for c in chosen}
        for u in vs:
            edges.append((v, u))
            repeated.append(u)
            repeated.append(v)
            if rng.random() < tri_p and len(vs) > 1:
                # close a triangle through a random existing neighbor of u
                w = repeated[rng.integers(0, len(repeated))]
                if w != v and w != u:
                    edges.append((v, w))
                    repeated.append(w)
                    repeated.append(v)
    del targets
    return np.asarray(edges, dtype=np.int64)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> np.ndarray:
    """Graph500-style RMAT generator, fully vectorised. n = 2**scale."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = r > (a + b)
        r2 = rng.random(m)
        thresh = np.where(src_bit, c / (c + (1 - a - b - c)), a / (a + b))
        dst_bit = r2 > thresh
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)


def clique_planted(n: int, m_background: int, clique_sizes: tuple[int, ...],
                   seed: int = 0) -> np.ndarray:
    """ER background with planted cliques — ground truth for k-clique tests."""
    rng = np.random.default_rng(seed)
    edges = [erdos_renyi(n, m_background, seed)]
    used = 0
    for k in clique_sizes:
        vs = np.arange(used, used + k, dtype=np.int64)
        used += k
        ii, jj = np.triu_indices(k, 1)
        edges.append(np.stack([vs[ii], vs[jj]], axis=1))
    del rng
    return np.concatenate(edges, axis=0)
