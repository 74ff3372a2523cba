"""The port's traced dispatch and session spans against the JAX package's.

With tracing on, benchmarks/ci_gate.py:measure_telemetry's session mix on
email-eu-core 0.25 must give benchmarks/baseline.json's
``exact.telemetry.email-eu-core@0.25.*`` values, and the span tree of a
query must equal the JAX package's span for span, attributes included;
with tracing off no span opens, and the counts and counters are the
traced run's. The port's ``host`` spans (``launch``, ``sync``, ``slice``,
``upload``: where the host launches, waits, slices and uploads) have no
counterpart in the JAX package, and are left out of both comparisons;
every span of the JAX package's categories is compared.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import pytest

from repro.graph import get_dataset as jget_dataset
from repro.mining.session import Miner as JMiner
from repro.obs import Telemetry as JTelemetry
from repro_torch import Miner, MinerConfig
from repro_torch.graph import get_dataset
from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
from repro_torch.obs import Telemetry, Tracer
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / "baseline.json"
TAG = "telemetry.email-eu-core@0.25"


def _mix(miner) -> dict:
    return {"T": miner.count("triangle"), "TC": miner.count("three-chain"),
            "TT": miner.count("tailed-triangle"), "4C": miner.count("4-clique"),
            "4M": list(miner.count_many(list(FOUR_MOTIF_SHAPES)))}


def test_telemetry_mix_equals_baseline_json():
    exact = json.loads(BASELINE.read_text())["exact"]
    g = get_dataset("email-eu-core", 0.25)
    tel = Telemetry(enabled=True)
    traced = Miner(g, device="cpu", telemetry=tel)
    counts = _mix(traced)
    plain = Miner(g, device="cpu")
    assert not plain.telemetry.enabled
    plain_counts = _mix(plain)
    reg, rs, sess = tel.metrics, dict(traced.runner.stats), traced.stats
    keys = ("queries", "plan_hits", "plan_misses", "schedule_hits", "schedule_misses")
    by_cat: dict = {}
    for sp in tel.tracer.spans():
        if sp.cat != "host":
            by_cat[sp.cat] = by_cat.get(sp.cat, 0) + 1
    assert all(reg.value(k) == v for k, v in rs.items())
    assert all(reg.value(k) == sess[k] for k in keys)
    assert exact[f"{TAG}.registry_equals_legacy"] is True
    assert (counts == plain_counts and sess == plain.stats) is \
        exact[f"{TAG}.enabled_disabled_parity"] is True
    assert rs == exact[f"{TAG}.runner_stats"]
    assert {k: sess[k] for k in keys} == exact[f"{TAG}.session_counters"]
    assert by_cat == exact[f"{TAG}.span_counts"] == {"dispatch": 43, "level": 49, "span": 20}
    want = exact["email-eu-core@0.25.session.counts"]
    assert dict(zip(FOUR_MOTIF_SHAPES, counts.pop("4M"))) == want["4M"]
    assert counts == {k: want[k] for k in ("T", "TC", "TT", "4C")}


def _tree(span) -> tuple:
    """A span without its times: (name, cat, attrs, children), the port's
    ``host`` spans (no ``host`` span has children) and its dispatch spans'
    ``inplace`` and ``form`` attributes (a leaf read in place) left out."""
    attrs = {k: v for k, v in span.attrs.items() if k not in ("inplace", "form")}
    return (span.name, span.cat, attrs,
            [_tree(c) for c in span.children if c.cat != "host"])


@pytest.mark.parametrize("device_compact", [True, False])
def test_span_trees_equal_jax(device_compact):
    """Counts, embeddings and a batch: every span, its attributes (op kind
    and level, items, capacities, executable-cache hits, host) and its
    nesting equal the JAX package's."""
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    tel, jtel = Telemetry(enabled=True), JTelemetry(enabled=True)
    m = Miner(g, device="cpu", device_compact=device_compact, telemetry=tel)
    jm = JMiner(jg, backend="xla", device_compact=device_compact, telemetry=jtel)
    for miner in (m, jm):
        miner.count("4-clique")
        miner.embeddings("diamond")
        miner.embeddings("triangle")
        miner.count_many(["triangle", "4-cycle"])
        miner.count("4-clique")
    got = [_tree(r) for r in tel.tracer.finished]
    assert got == [_tree(r) for r in jtel.tracer.finished]
    assert len(got) == 5 and sum(1 for _ in tel.tracer.spans("dispatch")) > 5


def _off_mix(miner) -> tuple:
    """Every site that opens a span when tracing: emit, a count, a forest
    with a residual pack and a riding leaf, and a weighted leaf."""
    return (miner.embeddings("4-cycle"), miner.count("paw"),
            miner.count_many(["4-clique", "diamond", "4-cycle", "paw", "4-path"]))


@pytest.mark.parametrize("device_compact", [True, False])
def test_disabled_tracer_opens_no_span(monkeypatch, device_compact):
    """Tracing off: no span is opened or built at any site (the engine's
    ``upload``, ``sync`` and ``slice`` among them; the host path's uploads
    and reads too), and the rows and counters equal the traced session's."""
    g = get_dataset("email-eu-core", 0.25)
    traced = Miner(g, device="cpu", telemetry=Telemetry(enabled=True),
                   device_compact=device_compact)
    want = _off_mix(traced)
    host = {sp.name for sp in traced.telemetry.tracer.spans() if sp.cat == "host"}
    assert host == {"upload", "sync"} | ({"slice"} if device_compact else set())
    opened = []
    monkeypatch.setattr(Tracer, "span", lambda self, *a, **k: opened.append(a))
    plain = Miner(g, device="cpu", device_compact=device_compact)
    got = _off_mix(plain)
    assert opened == [] and plain.telemetry.tracer.finished == []
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and plain.stats == traced.stats
    assert dict(plain.runner.stats) == dict(traced.runner.stats)


def test_miner_config_from_args():
    ns = argparse.Namespace(chunk=64, trace="out.json", device="cpu", shards=0)
    cfg = MinerConfig.from_args(ns)
    assert (cfg.chunk, cfg.device, cfg.telemetry.enabled) == (64, "cpu", True)
    assert not MinerConfig.from_args(argparse.Namespace()).telemetry.enabled
    assert MinerConfig.from_args(argparse.Namespace()).device == "cuda"
    assert MinerConfig.from_args(ns, chunk=None).chunk is None
    # telemetry is no execution knob: equal configs either way
    assert cfg == MinerConfig(chunk=64, device="cpu")
    m = Miner(get_dataset("citeseer", 1.0), cfg)
    assert m.telemetry is cfg.telemetry and m.runner.telemetry is cfg.telemetry
    assert MinerConfig.from_args(argparse.Namespace(shards=8)).mesh == 8
    one = MinerConfig.from_args(argparse.Namespace(shards=1))
    assert one.chunk is None and one.mesh is None
