"""The port's SVPU value plane (repro_torch.graph value fields,
repro_torch.values) and its weighted queries against the JAX package's.

The weighted CSR, the padded value rows and the per-(vertex, key) weight
lookups must equal the JAX package's bit for bit on the same numpy inputs;
``Miner(g, device="cpu").aggregate`` must equal the host float64 oracle
(``repro.mining.reference.weighted_pattern_oracle``) exactly on tiny graphs,
and the engine counters of a weighted query must equal the JAX engine's and
its unweighted twin's.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import build_csr as jbuild_csr
from repro.graph import get_dataset as jget_dataset
from repro.graph import padded_value_rows as jpadded_value_rows
from repro.graph import with_edge_values as jwith_edge_values
from repro.graph.csr import edge_list as jedge_list
from repro.mining import reference
from repro.mining.session import Miner as JMiner
from repro.values import edge_value_lookup as jedge_value_lookup
from repro.values import prefix_scale as jprefix_scale
from repro_torch import Miner
from repro_torch.core.stream import SENTINEL
from repro_torch.graph import (build_csr, edge_list, edge_weights, from_reference_arrays,
                               get_dataset, padded_rows, padded_value_rows, to_numpy,
                               with_edge_values)
from repro_torch.graph.generators import erdos_renyi
from repro_torch.values import edge_value_lookup, prefix_scale

from _torch_rows import AGG_OPS, AGG_QUERIES
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BASELINE = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                       / "baseline.json").read_text())["exact"]
TINY_EDGES = erdos_renyi(20, 70, seed=7)      # tests/test_values.py's TINY


def _weighted(g, seed):
    return with_edge_values(g, edge_weights(edge_list(g), seed=seed))


def _jweighted(jg, seed):
    return jwith_edge_values(jg, edge_weights(jedge_list(jg), seed=seed))


def _graphs():
    """(port graph, JAX graph) pairs, weighted the same way."""
    return {"tiny": (_weighted(build_csr(TINY_EDGES, 20), 11),
                     _jweighted(jbuild_csr(TINY_EDGES, 20), 11)),
            "email-eu-core@0.25": (_weighted(get_dataset("email-eu-core", 0.25), 0),
                                   _jweighted(jget_dataset("email-eu-core", 0.25), 0))}


GRAPHS = _graphs()


def _assert_arrays_equal(g, jg):
    got = to_numpy(g)
    for f in ("indptr", "indices", "offsets", "degrees", "edge_values"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jg, f)), err_msg=f)
    assert (g.num_vertices, g.num_edges, g.max_degree) == \
        (jg.num_vertices, jg.num_edges, jg.max_degree)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_with_edge_values_equals_jax(name):
    g, jg = GRAPHS[name]
    assert g.weighted and jg.weighted and g.edge_values.dtype == torch.float32
    _assert_arrays_equal(g, jg)
    bare = dataclasses.replace(g, edge_values=None)
    assert not bare.weighted
    assert _weighted(bare, 0).indices is bare.indices       # keys are shared
    with pytest.raises(ValueError):
        with_edge_values(bare, np.ones(g.num_edges + 3, np.float32))


def test_build_csr_values_ride_the_key_permutation_as_in_jax():
    """Shuffled, mirrored and duplicated input edges with their weights."""
    rng = np.random.default_rng(0)
    base = erdos_renyi(30, 90, seed=2)
    messy = np.concatenate([base, base[::-1, ::-1], base[:20], [[4, 4]]])
    messy = messy[rng.permutation(len(messy))]
    w = edge_weights(messy, seed=9)
    for undirected in (True, False):
        g = build_csr(messy, 30, undirected=undirected, edge_values=w)
        jg = jbuild_csr(messy, 30, undirected=undirected, edge_values=w)
        _assert_arrays_equal(g, jg)
    with pytest.raises(ValueError):
        build_csr(messy, 30, edge_values=w[:-1])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_reference_arrays_round_trip_edge_values(name):
    g, jg = GRAPHS[name]
    arrays = {f: np.asarray(getattr(jg, f)) for f in
              ("indptr", "indices", "offsets", "degrees", "edge_values")}
    back = from_reference_arrays(arrays, jg.num_vertices, jg.num_edges, jg.max_degree,
                                 device="cpu")
    _assert_arrays_equal(back, jg)
    out = to_numpy(back)
    assert out["edge_values"].dtype == np.float32
    np.testing.assert_array_equal(out["edge_values"], arrays["edge_values"])
    assert "edge_values" not in to_numpy(dataclasses.replace(back, edge_values=None))
    moved = back.to("cpu")
    assert moved.weighted and torch.equal(moved.edge_values, back.edge_values)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_padded_value_rows_equal_jax(name):
    g, jg = GRAPHS[name]
    rng = np.random.default_rng(1)
    vs = rng.integers(0, g.num_vertices, size=64).astype(np.int32)
    for cap in (128, 256):
        got = padded_value_rows(g, torch.from_numpy(vs), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpadded_value_rows(jg, vs, cap)))
        keys, _ = padded_rows(g, torch.from_numpy(vs), cap)
        assert not got[keys == SENTINEL].any()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_edge_value_lookup_and_prefix_scale_equal_jax(name):
    """Random (vertex, key) pairs, a third of them real edges, some keys
    SENTINEL padding or past every window; 2-D and 1-D forms."""
    g, jg = GRAPHS[name]
    rng = np.random.default_rng(3)
    e = edge_list(g)
    us = rng.integers(0, g.num_vertices, size=200).astype(np.int32)
    keys = rng.integers(0, g.num_vertices + 5, size=(200, 7)).astype(np.int32)
    keys[rng.random(keys.shape) < 0.15] = SENTINEL
    pick = rng.integers(0, len(e), size=70)
    us[:70], keys[:70, 0] = e[pick, 0], e[pick, 1]
    got = edge_value_lookup(g, torch.from_numpy(us), torch.from_numpy(keys))
    want = np.asarray(jedge_value_lookup(jg, us, keys))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:70, 0] > 0).all()
    got1 = edge_value_lookup(g, torch.from_numpy(us), torch.from_numpy(keys[:, 0].copy()))
    np.testing.assert_array_equal(got1.numpy(), want[:, 0])
    # prefix columns hold vertex ids: the first is a neighbour of us for 70 rows
    col1 = np.where(np.arange(200) < 70, keys[:, 0],
                    rng.integers(0, g.num_vertices, size=200)).astype(np.int32)
    get = {0: us, 1: col1, 2: rng.integers(0, g.num_vertices, size=200).astype(np.int32)}
    for edges in ((), ((0, 1),), ((0, 1), (0, 2), (1, 2))):
        sc = prefix_scale(g, {c: torch.from_numpy(v) for c, v in get.items()}, edges)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(
            jprefix_scale(jg, {c: jnp.asarray(v) for c, v in get.items()}, edges)))


def test_value_lookups_require_weights():
    g = build_csr(TINY_EDGES, 20)
    vs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        edge_value_lookup(g, vs, vs)
    with pytest.raises(ValueError):
        padded_value_rows(g, vs, 128)


# the oracle enumerates permutations of the tiny graph: 5-clique is left out
ORACLE_QUERIES = [q for q in AGG_QUERIES if q != "5-clique"]


@pytest.mark.parametrize("query", ORACLE_QUERIES)
def test_aggregate_equals_weighted_oracle(query):
    g, jg = GRAPHS["tiny"]
    pat = JMiner(jg, backend="xla").compile(query, aggregate="sum").pattern
    m = Miner(g, device="cpu", chunk=128)
    for op in AGG_OPS:
        assert m.aggregate(query, op) == reference.weighted_pattern_oracle(jg, pat, op), op


def test_aggregate_equals_baseline_oracle_values():
    """benchmarks/baseline.json's oracle values (erdos_renyi(22, 80, seed=5),
    weights seed 3), exactly."""
    g = _weighted(build_csr(erdos_renyi(22, 80, seed=5), 22), 3)
    m = Miner(g, device="cpu")
    want = BASELINE["values.email-eu-core@0.25.oracle_values"]
    got = {q: {op: m.aggregate(q, op) for op in AGG_OPS} for q in want}
    assert got == want


def _counters(m) -> dict:
    st = dict(m.stats["runner"])
    out = {k: st[k] for k in ("exec_misses", "exec_hits", "items", "device_compactions",
                              "level_kernel_dispatches")}
    for k in ("feed_chunks", "value_lane_dispatches"):
        out[k] = m.metrics.counter(k).value
    return out


@pytest.mark.parametrize("fused_level", [True, False])
def test_aggregate_counters_equal_jax_engine_and_unweighted_twin(fused_level):
    """chunk = 128 on a 60-vertex graph: several chunks with padded tails.
    Every counter equals the JAX engine's (value lanes too, one per
    aggregate-leaf call); feed chunks and level dispatches equal the
    unweighted twin's, except for tailed-triangle, whose count plan folds
    its last level into a degree factor that a weighted plan cannot use."""
    edges = erdos_renyi(60, 240, seed=3)
    g, jg = _weighted(build_csr(edges, 60), 5), _jweighted(jbuild_csr(edges, 60), 5)
    tm = Miner(g, device="cpu", chunk=128, fused_level=fused_level)
    jm = JMiner(jg, backend="xla", chunk=128, fused_level=fused_level)
    twin = Miner(g, device="cpu", chunk=128, fused_level=fused_level)
    for q in AGG_QUERIES:
        before, twin_before = _counters(tm), _counters(twin)
        assert tm.aggregate(q, "sum") == jm.aggregate(q, "sum"), q
        assert _counters(tm) == _counters(jm), q
        twin.count(q)
        added = {k: v - before[k] for k, v in _counters(tm).items()}
        twin_added = {k: v - twin_before[k] for k, v in _counters(twin).items()}
        assert added["value_lane_dispatches"] > 0 == twin_added["value_lane_dispatches"]
        if q == "tailed-triangle":
            assert len(tm.compile(q, "sum").ops) == len(twin.compile(q).ops) + 1
            continue
        for k in ("feed_chunks", "level_kernel_dispatches", "items", "device_compactions"):
            assert added[k] == twin_added[k], (q, k)


def test_weighted_queries_cost_what_their_twins_cost():
    """benchmarks/baseline.json's SVPU gate: T and 4C on email-eu-core 0.25
    issue the same level dispatches ([1, 1], [2, 2]) and feed chunks
    ([1, 1]) weighted and unweighted, with one value lane per query, and
    the exact aggregates."""
    g = GRAPHS["email-eu-core@0.25"][0]
    m = Miner(g, device="cpu")
    lanes0 = m.metrics.counter("value_lane_dispatches").value
    for app, q in (("T", "triangle"), ("4C", "4-clique")):
        row = {}
        for mode, fn in (("count", lambda q=q: m.count(q)),
                         ("aggregate", lambda q=q: m.aggregate(q, "sum"))):
            d0 = m.stats["runner"]["level_kernel_dispatches"]
            f0 = m.metrics.counter("feed_chunks").value
            res = fn()
            row[mode] = (res, m.stats["runner"]["level_kernel_dispatches"] - d0,
                         m.metrics.counter("feed_chunks").value - f0)
        pre = f"values.email-eu-core@0.25.{app}."
        assert row["count"][0] == BASELINE[pre + "count"]
        assert row["aggregate"][0] == BASELINE[pre + "aggregate"]
        assert [row["count"][1], row["aggregate"][1]] == BASELINE[pre + "dispatches"]
        assert [row["count"][2], row["aggregate"][2]] == BASELINE[pre + "feed_chunks"]
    assert m.metrics.counter("value_lane_dispatches").value - lanes0 == \
        BASELINE["values.email-eu-core@0.25.value_lane_dispatches"]


def test_repeated_aggregate_rebuilds_nothing():
    g = GRAPHS["email-eu-core@0.25"][0]
    m = Miner(g, device="cpu")
    first = [m.aggregate(q, op) for q in ("triangle", "paw") for op in ("sum", "max")]
    rebuilds = m.stats["rebuilds"]
    assert rebuilds > 0
    assert [m.aggregate(q, op) for q in ("triangle", "paw") for op in ("sum", "max")] == first
    st = m.stats
    assert st["rebuilds"] == rebuilds and st["plan_hits"] == 4
    # a count and an aggregate of one query are separate plans and executables
    m.count("triangle")
    assert m.stats["plan_misses"] == 5 and m.stats["rebuilds"] > rebuilds


def test_aggregate_guards_as_in_jax():
    with pytest.raises(ValueError, match="weighted graph"):
        Miner(build_csr(TINY_EDGES, 20), device="cpu").aggregate("triangle")
    g = GRAPHS["tiny"][0]
    with pytest.raises(ValueError):
        Miner(g, device="cpu").aggregate("triangle", "avg")
    with pytest.raises(ValueError):          # div != 1: no symmetry-broken schedule
        Miner(g, device="cpu").aggregate("triangle-nested")
