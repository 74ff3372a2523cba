"""Deterministic synthetic twins of the paper's Table IV datasets.

Nothing is downloaded: each of the ten real graphs is
replaced by a generator parameterised to match its (#V, #E, skew). Relative
trends the paper relies on (denser graph => longer streams => larger
speedups; heavy-tail graphs => long max streams) are reproduced; absolute
counts obviously differ from the real graphs.

``get_dataset(name, scale=1.0)`` returns a CPU CSRGraph (move it to a
device with ``CSRGraph.to``); ``scale`` < 1 shrinks
#V/#E proportionally so the big twins (youtube/patent/livejournal) stay
cheap to build. Table IV:
    citeseer 3.3K/4.5K | email-eu-core 1.0K/16.1K | bitcoinalpha 3.8K/24K
    gnutella 6K/21K    | haverford 1.4K/60K       | wiki-vote 7K/104K
    mico 96.6K/1.1M    | youtube 1.1M/3.0M        | patent 3.8M/16.5M
    livejournal 4.8M/42.9M
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .csr import CSRGraph, build_csr
from .generators import erdos_renyi, powerlaw_cluster, rmat

# name -> (V, E, kind, params)
DATASETS: dict[str, dict] = {
    # small, low-skew citation graph
    "citeseer":      dict(v=3300, e=4500, kind="er", tag="C"),
    # small dense email graph, high average degree
    "email-eu-core": dict(v=1000, e=16100, kind="plc", m=16, tag="E"),
    "bitcoinalpha":  dict(v=3800, e=24000, kind="plc", m=6, tag="B"),
    "gnutella":      dict(v=6000, e=21000, kind="er", tag="G"),
    # very dense facebook subgraph
    "haverford":     dict(v=1400, e=60000, kind="plc", m=42, tag="F"),
    "wiki-vote":     dict(v=7000, e=104000, kind="plc", m=15, tag="W"),
    "mico":          dict(v=96600, e=1100000, kind="plc", m=11, tag="M"),
    # large heavy-tail graphs: vectorised RMAT twins
    "youtube":       dict(v=1 << 20, e=3000000, kind="rmat", scale=20, ef=3, tag="Y"),
    "patent":        dict(v=1 << 22, e=16500000, kind="rmat", scale=22, ef=4, tag="P"),
    "livejournal":   dict(v=1 << 22, e=42900000, kind="rmat", scale=22, ef=10, tag="L"),
}


def _edges_for(name: str, scale: float, seed: int) -> tuple[np.ndarray, int]:
    spec = DATASETS[name]
    v = max(int(spec["v"] * scale), 64)
    e = max(int(spec["e"] * scale), 64)
    kind = spec["kind"]
    if kind == "er":
        return erdos_renyi(v, e, seed=seed), v
    if kind == "plc":
        m = max(1, int(round(e / v)))
        return powerlaw_cluster(v, m, seed=seed), v
    if kind == "rmat":
        # pick the RMAT scale whose 2**s is closest >= v
        s = max(8, int(np.ceil(np.log2(v))))
        ef = max(1, int(round(e / (1 << s))))
        return rmat(s, edge_factor=ef, seed=seed), 1 << s
    raise ValueError(kind)


@lru_cache(maxsize=16)
def get_dataset(name: str, scale: float = 1.0, seed: int = 0) -> CSRGraph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    edges, v = _edges_for(name, scale, seed)
    return build_csr(edges, num_vertices=v, undirected=True)


def dataset_stats(g: CSRGraph) -> dict:
    deg = g.degrees.cpu().numpy()
    return dict(V=g.num_vertices, E=g.num_edges // 2,
                avg_deg=float(deg.mean()), max_deg=int(deg.max()))
