"""The configurations' generated graphs: the fitted twin against the
published statistics it was fitted to, the edge list's cache, and the
seed's order of the edge list."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import graphs, reference

BENCH = Path(__file__).resolve().parent
CONFIGS = sorted(BENCH.glob("configs/*.json"))


def config(path):
    return json.loads(Path(path).read_text())


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda p: p.stem)
def full(request):
    cfg = config(request.param)
    edges, v = graphs.edges_of(cfg)
    g = reference.Adjacency(edges, v)
    tri = g.grow(torch.stack([g.out_src, g.out_dst], 1)).shape[0]
    stats = {"vertices": v, "edges": g.keys.numel() // 2,
             "max_degree": int(g.degree.max()), "triangle": tri,
             "isolated": int((g.degree == 0).sum())}
    return cfg, edges, v, stats


@pytest.mark.parametrize("stat", ["vertices", "edges", "max_degree", "triangle"])
def test_full_size_graph_is_what_the_config_states(full, stat):
    """At full size: equal to ``at_every_seed``, and within ``tolerance`` of
    the published figure it was fitted to (the vertices exactly)."""
    cfg, _, _, stats = full
    assert stats[stat] == cfg["at_every_seed"][stat]
    pub = cfg["published"]
    tol = 0 if stat == "vertices" else pub["tolerance"]
    assert abs(stats[stat] / pub[stat] - 1) <= tol


def test_edge_list_is_simple(full):
    _, edges, v, stats = full
    assert stats["isolated"] == 0
    assert edges.dtype == np.int64 and (edges[:, 0] < edges[:, 1]).all()
    assert edges.max() < v
    key = edges[:, 0] * v + edges[:, 1]
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_cache_gives_the_same_edges(path, tmp_path):
    cfg = config(path)
    want = graphs.edges_of(cfg, 0.01)
    first = graphs.edges_of(cfg, 0.01, tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    second = graphs.edges_of(cfg, 0.01, tmp_path)
    for got in (first, second):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    other = dict(cfg, generator=dict(cfg["generator"], seed=1))
    graphs.edges_of(other, 0.01, tmp_path)          # other parameters, another file
    assert len(list(tmp_path.iterdir())) == 2


def test_scale_keeps_the_papers():
    cfg = config(BENCH / "configs" / "mico.json")
    small, v = graphs.edges_of(cfg, 0.003)
    assert v == 289 and 1000 < small.shape[0] < 5000


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 1])
def test_relabel_is_a_seeded_permutation(seed):
    """The seed's draw: the edge list's order and each edge's direction, the
    same for the same seed, another for another; the graph and its vertex
    numbering stay."""
    edges, v = graphs.edges_of(config(BENCH / "configs" / "mico.json"), 0.01)
    a = graphs.shuffle(edges, seed)
    np.testing.assert_array_equal(a, graphs.shuffle(edges, seed))
    b = graphs.shuffle(edges, seed + 1)
    assert not np.array_equal(a, b)

    def undirected(e):
        return np.unique(np.sort(e, axis=1), axis=0)
    np.testing.assert_array_equal(undirected(a), undirected(edges))
    assert (a != np.sort(a, axis=1)).any(axis=1).any()      # some edges turned
    graphs.shuffle(edges, -7)               # any whole number is a seed


@pytest.mark.parametrize("seed", [1, 2**31 + 99, 2**33 + 9])
def test_counts_do_not_depend_on_the_seed(seed):
    edges, v = graphs.edges_of(config(BENCH / "configs" / "mico.json"), 0.003)
    want = reference.counts(edges, v)
    assert reference.counts(graphs.shuffle(edges, seed), v) == want
