"""The port's plan forest (``Miner.count_many`` / ``aggregate_many`` /
``run_plans``, ``WaveRunner.run_set``) and host-compaction path
(``device_compact=False``) against the JAX package's.

On the same graphs the counts, every runner counter (host syncs, count
rides and executable-cache hits and misses included) and the per-(kind,
level) ``level_execs`` must equal the JAX engine's, in both compaction
modes; under ``record=True`` the waves must equal wave for wave.
"""
import dataclasses

import numpy as np
import pytest

from repro.graph import build_csr as jbuild_csr
from repro.graph import get_dataset as jget_dataset
from repro.graph import with_edge_values as jwith_edge_values
from repro.graph.csr import edge_list as jedge_list
from repro.mining import engine as jengine
from repro.mining import plan as JP
from repro.mining.forest import build_forest as jbuild_forest
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.graph import build_csr, edge_list, edge_weights, get_dataset, with_edge_values
from repro_torch.graph.generators import erdos_renyi
from repro_torch.mining import engine
from repro_torch.mining import plan as P
from repro_torch.mining.forest import build_forest

from test_plan import _seeded_pattern

# the JAX package's numbers on email-eu-core 0.25 (its CPU run, backend xla)
TM = [11502, 138732]
FOUR_M = [10622, 151646, 161630, 1035535, 3252244, 1652486]
ER_EDGES = erdos_renyi(60, 240, seed=3)     # tests/test_forest.py's "er"
TINY_EDGES = erdos_renyi(18, 48, seed=7)    # tests/test_forest.py's TINY


@pytest.fixture(scope="module")
def email():
    return get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)


def _state(m) -> tuple:
    return dict(m.runner.stats), dict(m.runner.level_execs)


def _batch(name):
    return {"TM": [P.TRIANGLE, P.THREE_CHAIN_INDUCED],
            "4M": list(P.FOUR_MOTIF_SHAPES),
            "T+4C": [P.TRIANGLE, P.clique_pattern(4)]}[name]


@pytest.mark.parametrize("device_compact", [True, False])
@pytest.mark.parametrize("batch,want", [("TM", TM), ("4M", FOUR_M),
                                        ("T+4C", [11502, 10622])])
def test_count_many_counts_counters_and_level_execs_equal_jax(email, batch, want,
                                                              device_compact):
    g, jg = email
    m = Miner(g, device="cpu", device_compact=device_compact)
    jm = JMiner(jg, backend="xla", device_compact=device_compact)
    jq = [JP.TRIANGLE, JP.THREE_CHAIN_INDUCED] if batch == "TM" else \
        [JP.TRIANGLE, JP.clique_pattern(4)] if batch == "T+4C" else list(JP.FOUR_MOTIF_SHAPES)
    assert m.count_many(_batch(batch)) == jm.count_many(jq) == want
    st, execs = _state(m)
    assert st == dict(jm.runner.stats) and execs == dict(jm.runner.level_execs)
    assert st["count_rides"] == (batch == "T+4C")
    assert st["host_compactions" if device_compact else "device_compactions"] == 0


def test_four_motif_counters_of_both_modes(email):
    """The two modes' counters on 4M: the host path packs no residuals, so
    its count leaves run on more chunks; the items are the same."""
    got = {}
    for dc in (True, False):
        m = Miner(email[0], device="cpu", device_compact=dc)
        assert m.count_many(_batch("4M")) == FOUR_M
        got[dc] = _state(m)
    (dev, dev_x), (host, host_x) = got[True], got[False]
    assert (dev["device_compactions"], dev["host_compactions"], dev["items"],
            dev["level_kernel_dispatches"], dev["host_syncs"]) == (3, 0, 358319, 38, 41)
    assert (host["device_compactions"], host["host_compactions"], host["items"],
            host["level_kernel_dispatches"], host["host_syncs"]) == (0, 3, 358319, 45, 45)
    assert dev_x == {("expand", 2): 3, ("count", 3): 35}
    assert host_x == {("expand", 2): 3, ("count", 3): 42}


@pytest.mark.parametrize("device_compact", [True, False])
def test_single_plans_on_the_host_path_equal_jax(email, device_compact):
    g, jg = email
    m = Miner(g, device="cpu", device_compact=device_compact)
    jm = JMiner(jg, backend="xla", device_compact=device_compact)
    for q in ("4-clique", "5-clique", "4-cycle", "tailed-triangle"):
        assert m.count(q) == jm.count(q), q
        assert _state(m) == (dict(jm.runner.stats), dict(jm.runner.level_execs)), q


def _traces(runner_of, run):
    """{mode: (result, trace)} of ``run(runner)`` on record=True runners."""
    out = {}
    for dc in (True, False):
        r = runner_of(dc)
        out[dc] = (run(r), r.trace)
    return out


def _assert_traces_equal(t1, t2):
    assert len(t1) == len(t2) > 0
    for (l1, r1, v1), (l2, r2, v2) in zip(t1, t2):
        assert l1 == l2
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(v1, v2)


@pytest.mark.parametrize("chunk", [None, 128])
def test_waves_equal_between_modes_and_jax(chunk):
    """Clique plans and a residual-free forest record the same waves in
    both modes; a 4-motif forest records the JAX engine's waves in each
    mode (the modes differ there: only the device path packs residuals)."""
    from repro_torch.mining.session import ExecutableCache
    g, jg = build_csr(ER_EDGES, 60), jbuild_csr(ER_EDGES, 60)

    def port(dc):
        return engine.WaveRunner(g, ExecutableCache(), chunk=chunk, device_compact=dc,
                                 record=True)

    def jax_(dc):
        return jengine.WaveRunner(jg, chunk=chunk, backend="xla", device_compact=dc,
                                  record=True)

    runs = [lambda r: r.run(P.compile_pattern(P.clique_pattern(4))),
            lambda r: r.run(P.compile_pattern(P.clique_pattern(5))),
            lambda r: r.run_set(build_forest([P.compile_pattern(p) for p in
                                              (P.TRIANGLE, P.clique_pattern(4))]))]
    for run in runs:
        t = _traces(port, run)
        assert t[True][0] == t[False][0]
        _assert_traces_equal(t[True][1], t[False][1])
    motifs = [P.compile_pattern(p) for p in P.FOUR_MOTIFS.values()]
    jmotifs = [JP.compile_pattern(p) for p in JP.FOUR_MOTIFS.values()]
    tp = _traces(port, lambda r: r.run_set(build_forest(motifs)))
    tj = _traces(jax_, lambda r: r.run_set(jbuild_forest(jmotifs)))
    for dc in (True, False):
        assert tp[dc][0] == tj[dc][0]
        _assert_traces_equal(tp[dc][1], tj[dc][1])


def _weighted(g):
    return with_edge_values(g, edge_weights(edge_list(g), seed=0))


@pytest.fixture(scope="module")
def weighted_email(email):
    g, jg = email
    return _weighted(g), jwith_edge_values(jg, edge_weights(jedge_list(jg), seed=0))


def test_aggregate_many_equals_per_query_and_jax(weighted_email):
    """The sums within rtol 1e-6 of the JAX package's (f32 partials in
    other orders) and bit for bit against per-query calls; a repeat
    rebuilds nothing."""
    g, jg = weighted_email
    m = Miner(g, device="cpu")
    names = list(P.FOUR_MOTIF_SHAPES)
    batch = m.aggregate_many(names, "sum")
    assert batch == [m.aggregate(n, "sum") for n in names]
    want = JMiner(jg, backend="xla").aggregate_many(names, "sum")
    assert batch == pytest.approx(want, rel=1e-6, abs=0)
    rebuilds = m.stats["rebuilds"]
    assert m.aggregate_many(names, "sum") == batch
    assert m.stats["rebuilds"] == rebuilds


def test_aggregate_many_on_the_host_path(weighted_email):
    """Max over the host path equals per-query calls and the device path,
    bit for bit (a max is exact in any order)."""
    g, _ = weighted_email
    host, dev = Miner(g, device="cpu", device_compact=False), Miner(g, device="cpu")
    names = list(P.FOUR_MOTIF_SHAPES)
    batch = host.aggregate_many(names, "max")
    assert batch == [host.aggregate(n, "max") for n in names] \
        == dev.aggregate_many(names, "max")
    assert host.stats["runner"]["host_compactions"] > 0


def test_count_and_aggregate_leaves_share_one_feed_pass(email):
    """A count leaf and aggregate leaves over one stream fuse into one feed
    pass with the single count's feed chunks, both results exact."""
    m = Miner(_weighted(email[0]), device="cpu")
    plans = [P.compile_pattern(P.TRIANGLE), P.compile_pattern(P.TRIANGLE, aggregate="sum"),
             P.compile_pattern(P.TRIANGLE, aggregate="max")]
    assert build_forest(plans).sharing_stats()["feed_passes"]["fused"] == 1
    chunks = m.metrics.counter("feed_chunks")
    got = m.run_plans(plans)
    fused_chunks = chunks.value
    assert got == [11502, m.aggregate("triangle", "sum"), m.aggregate("triangle", "max")]
    assert got[1] == 2835.9375
    assert chunks.value == 3 * fused_chunks        # each single query: one pass


def test_run_plans_and_session_caches(email):
    """run_plans: one plan runs directly, several fuse through a cached
    forest; the session mix of benchmarks/bench_mining.py (T, TC, TT, 4C,
    then 4M through count_many, twice) rebuilds nothing on its second pass."""
    g = email[0]
    m = Miner(g, device="cpu")
    plans = [m.compile(q) for q in ("4-clique", "diamond", "paw")]
    assert m.run_plans(plans[:1]) == [10622]
    assert m.run_plans(plans) == m.run_plans(plans) == [10622, 151646, 1035535]
    st = m.stats
    assert (st["schedule_misses"], st["schedule_hits"]) == (1, 1)

    s = Miner(g, device="cpu")
    names = list(P.FOUR_MOTIF_SHAPES)

    def mix():
        return [s.count("triangle"), s.count("three-chain"), s.count("tailed-triangle"),
                s.count("4-clique"), s.count_many(names)]
    first = mix()
    rebuilds = s.stats["rebuilds"]
    assert mix() == first == [11502, 138732, 1769583, 10622, FOUR_M]
    st = s.stats
    assert rebuilds == st["exec_cache"]["entries"] == 20      # baseline.json's 20
    assert st["rebuilds"] == rebuilds
    assert (st["schedule_misses"], st["schedule_hits"]) == (1, 1)
    sharing = s.schedule(names).sharing_stats()
    assert sharing["feed_passes"] == {"independent": 6, "fused": 2}
    assert sharing["forest_ops"][("expand", 2)] == 3
    assert Miner._SESSION_KEYS == JMiner._SESSION_KEYS
    assert engine.WaveRunner._STAT_KEYS == jengine.WaveRunner._STAT_KEYS


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_pattern_sets_fuse_bit_identically(seed):
    """Pairs of pseudo-random patterns (tests/test_forest.py's corpus):
    fused == per-plan runs == the JAX engine's forest, in both modes."""
    jpats = [_seeded_pattern(2 * seed), _seeded_pattern(2 * seed + 1)]
    pats = [P.Pattern(**dataclasses.asdict(p)) for p in jpats]
    g, jg = build_csr(TINY_EDGES, 18), jbuild_csr(TINY_EDGES, 18)
    plans = [P.compile_pattern(p) for p in pats]
    jplans = [JP.compile_pattern(p) for p in jpats]
    for dc in (True, False):
        m = Miner(g, device="cpu", device_compact=dc)
        fused = m.run_plans(plans)
        assert fused == [m.runner.run(pl) for pl in plans]
        assert fused == jengine.WaveRunner(jg, backend="xla", device_compact=dc).run_set(
            jbuild_forest(jplans)), (pats, dc)


def test_forest_with_emit_plans_equals_jax():
    """A mixed [count, emit] forest: results, counters and level_execs equal
    the JAX engine's in both modes; the count is the emitted rows."""
    plans = [P.compile_pattern(P.TRIANGLE), P.compile_pattern(P.TRIANGLE, emit=True)]
    jplans = [JP.compile_pattern(JP.TRIANGLE), JP.compile_pattern(JP.TRIANGLE, emit=True)]
    for dc in (True, False):
        m = Miner(build_csr(TINY_EDGES, 18), device="cpu", device_compact=dc)
        jm = JMiner(jbuild_csr(TINY_EDGES, 18), backend="xla", device_compact=dc)
        count, rows = m.run_plans(plans)
        jcount, jrows = jm.run_plans(jplans)
        assert count == jcount == len(rows) > 0
        np.testing.assert_array_equal(rows, np.asarray(jrows))
        assert _state(m) == _state(jm), dc


@pytest.mark.parametrize("app,want", [
    ("TM", {"triangle": 11502, "chain": 138732}),
    ("4M", dict(zip(P.FOUR_MOTIF_SHAPES, FOUR_M)))])
def test_launch_mine_batch_apps(capsys, app, want):
    from repro_torch.launch import mine
    args = ["--app", app, "--dataset", "email-eu-core", "--scale", "0.25", "--device", "cpu"]
    assert mine.main(args + (["--baseline"] if app == "TM" else [])) == want
    out = capsys.readouterr().out
    assert f"{app} = {want}" in out
    assert mine.main(args + ["--independent"]) == want


def test_launch_mine_forest_report_and_check(capsys):
    from repro_torch.launch import mine
    args = ["--app", "F4M", "--dataset", "email-eu-core", "--scale", "0.25",
            "--device", "cpu", "--check"]
    assert mine.main(args) == dict(zip(P.FOUR_MOTIF_SHAPES, FOUR_M))
    out = capsys.readouterr().out
    assert "6 plans, ops L2:6->3 L3:6->6, feed passes 6->2" in out
    assert "fused == independent per-plan counts OK" in out
