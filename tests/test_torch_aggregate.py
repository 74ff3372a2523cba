"""Weighted pattern queries, ``Miner(g, device="cpu").aggregate``, against
the JAX package's ``Miner.aggregate`` on email-eu-core 0.25 with the
weights ``edge_weights(edge_list(g), seed=0)``.

Every value is a product of dyadic weights, so max and min are equal bit
for bit, and so is every sum that f32 holds exactly in any summation order
(``sum_is_exact``); the other sums may round differently in the two
packages' orders and are held within rtol 1e-6. The T and 4C sums are
benchmarks/baseline.json's. Engine counters must equal the JAX engine's.
"""
import json
from pathlib import Path

import pytest

from repro.graph import get_dataset as jget_dataset
from repro.graph import with_edge_values as jwith_edge_values
from repro.graph.csr import edge_list as jedge_list
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.graph import edge_list, edge_weights, get_dataset, with_edge_values

from _torch_rows import AGG_OPS, AGG_QUERIES, sum_is_exact
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BASELINE = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                       / "baseline.json").read_text())["exact"]
COUNTERS = ("exec_misses", "exec_hits", "items", "device_compactions",
            "level_kernel_dispatches")


@pytest.fixture(scope="module")
def miners():
    g = get_dataset("email-eu-core", 0.25)
    jg = jget_dataset("email-eu-core", 0.25)
    g = with_edge_values(g, edge_weights(edge_list(g), seed=0))
    jg = jwith_edge_values(jg, edge_weights(jedge_list(jg), seed=0))
    return Miner(g, device="cpu"), JMiner(jg, backend="xla")


def _counters(m) -> dict:
    st = dict(m.stats["runner"])
    out = {k: st[k] for k in COUNTERS}
    for k in ("feed_chunks", "value_lane_dispatches"):
        out[k] = m.metrics.counter(k).value
    return out


@pytest.mark.parametrize("query", list(AGG_QUERIES))
def test_aggregate_equals_jax_miner(miners, query):
    tm, jm = miners
    for op in AGG_OPS:
        got, want = tm.aggregate(query, op), jm.aggregate(query, op)
        assert isinstance(got, float) and got > 0
        if op != "sum" or sum_is_exact(want, AGG_QUERIES[query]):
            assert got == want, op
        else:
            assert got == pytest.approx(want, rel=1e-6), op
        assert _counters(tm) == _counters(jm), op


def test_baseline_aggregates_exact(miners):
    tm, _ = miners
    for app, q in (("T", "triangle"), ("4C", "4-clique")):
        assert tm.aggregate(q, "sum") == BASELINE[f"values.email-eu-core@0.25.{app}.aggregate"]
    assert tm.aggregate("triangle", "sum") == 2835.9375
    assert tm.aggregate("4-clique", "sum") == 630.774658203125
