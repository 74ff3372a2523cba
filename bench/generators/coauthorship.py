"""A co-authorship graph: every paper a clique of its authors.

The vertices are authors. Every author holds one author slot, and
``extra`` more slots go to authors drawn with the weight
``(rank + 1) ** -beta`` over a random ranking, so a few authors write many
papers (the degree's heavy tail). The slots are shuffled and cut, in order,
into papers of ``2 + floor(lognormal(log(size_mean), size_sigma))`` authors,
and every pair of authors of a paper is an edge. Triangles come from the
papers' cliques, as in a real co-authorship graph, and the parameters are
fitted to a published graph's edges, maximum degree and triangles
(``bench/configs/<name>.json``). ``scale`` < 1 shrinks the authors and the
extra slots alike (the tests' sizes); the papers' sizes stay.
"""
from __future__ import annotations

import numpy as np


def generate(p: dict, scale: float = 1.0) -> tuple[np.ndarray, int]:
    """(edges (E, 2) int64 with lo < hi, each once, sorted; vertices)."""
    n = max(int(p["vertices"] * scale), 64)
    extra = int(p["extra"] * scale)
    rng_w, rng_m, rng_s = (np.random.default_rng([p["seed"], k]) for k in range(3))
    weight = (np.arange(n) + 1.0) ** -p["beta"]
    weight = weight[rng_w.permutation(n)]
    weight /= weight.sum()
    slots = np.concatenate([np.arange(n), rng_m.choice(n, size=extra, p=weight)])
    rng_m.shuffle(slots)
    sizes = 2 + np.floor(rng_s.lognormal(np.log(p["size_mean"]), p["size_sigma"],
                                         size=slots.size // 2)).astype(np.int64)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, slots.size))
    sizes = sizes[:k + 1].copy()
    sizes[-1] = slots.size - (ends[k - 1] if k else 0)     # the last paper takes the rest
    starts = np.cumsum(sizes) - sizes
    parts = [np.zeros((0, 2), dtype=np.int64)]
    for s in np.unique(sizes[sizes >= 2]):
        authors = slots[starts[sizes == s][:, None] + np.arange(s)]
        i, j = np.triu_indices(s, 1)
        parts.append(np.stack([authors[:, i].ravel(), authors[:, j].ravel()], 1))
    e = np.concatenate(parts)
    lo, hi = e.min(axis=1), e.max(axis=1)
    key = np.unique((lo * n + hi)[lo != hi])
    return np.stack([key // n, key % n], 1), n
