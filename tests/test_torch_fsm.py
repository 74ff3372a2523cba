"""The port's FSM (``mining.fsm``), the GRAMER-style baseline
(``mining.exhaustive``), the ``apps`` surface with the FSM feed, the
module-level waves and the launcher's FSM / exhaustive apps, against the
JAX package's and its brute-force oracle (``repro.mining.reference``).
"""
import importlib
import inspect
import warnings

import numpy as np
import pytest

from repro.graph import build_csr as jbuild_csr
from repro.graph import get_dataset as jget_dataset
from repro.mining import apps as japps
from repro.mining import engine as jengine
from repro.mining.exhaustive import exhaustive_count as jexhaustive_count
from repro.mining.fsm import fsm as jfsm
from repro.mining.fsm import sfsm as jsfsm
from repro.mining.reference import fsm_oracle
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.graph import build_csr, get_dataset
from repro_torch.graph.generators import clique_planted, erdos_renyi, powerlaw_cluster
from repro_torch.mining import apps, engine
from repro_torch.mining.exhaustive import PATTERN_CHECKS, exhaustive_count
from repro_torch.mining.fsm import fsm, random_labels, sfsm
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F = importlib.import_module("repro_torch.mining.fsm")
JF = importlib.import_module("repro.mining.fsm")


def _pair(edges, n):
    return build_csr(edges, n), jbuild_csr(edges, n)


def _state(m) -> tuple:
    return dict(m.runner.stats), dict(m.runner.level_execs)


@pytest.mark.parametrize("seed,nlab", [(1, 2), (2, 3), (3, 4)])
def test_fsm_equals_jax_and_oracle(seed, nlab):
    """tests/test_fsm.py's inputs: MNI support equal to the JAX package's
    and to the brute-force oracle."""
    g, jg = _pair(erdos_renyi(22, 55, seed=seed), 22)
    labels = random_labels(22, nlab, seed=seed)
    got = fsm(g, labels, min_support=2, device="cpu")
    assert got == jfsm(jg, labels, min_support=2, miner=JMiner(jg, backend="xla"))
    assert got == fsm_oracle(jg, labels, min_support=2, metric="mni")


@pytest.mark.parametrize("seed", [1, 4])
def test_sfsm_equals_jax_and_oracle_values(seed):
    """sFSM's count support: equal to the JAX package's, every reported
    value the oracle's count (misses are the closure bug test_fsm.py
    explains)."""
    g, jg = _pair(powerlaw_cluster(20, 3, seed=seed), 20)
    labels = random_labels(20, 3, seed=seed)
    got = sfsm(g, labels, min_support=3, device="cpu")
    assert got == jsfsm(jg, labels, min_support=3, miner=JMiner(jg, backend="xla"))
    want = fsm_oracle(jg, labels, min_support=3, metric="count")
    assert got and all(want.get(k) == v for k, v in got.items())


def test_fsm_on_email_eu_core_equals_jax():
    """Both supports on email-eu-core 0.25, labels random_labels(V, 2, 1),
    support 100 (every pattern kind frequent), one session held by the
    caller."""
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    labels = random_labels(g.num_vertices, 2, seed=1)
    np.testing.assert_array_equal(labels, JF.random_labels(jg.num_vertices, 2, seed=1))
    m, jm = Miner(g, device="cpu"), JMiner(jg, backend="xla")
    got = fsm(g, labels, 100, miner=m)
    assert got == jfsm(jg, labels, 100, miner=jm)
    assert {k[0] for k in got} == {"edge", "wedge", "triangle", "star3", "path4"}
    got = sfsm(g, labels, 100, miner=m)
    assert got == jsfsm(jg, labels, 100, miner=jm) and len(got) > 20
    assert _state(m) == _state(jm) and m.stats["runner"]["items"] == 2 * 11502


def test_fsm_domain_code_equals_the_original():
    """The numpy domain code is the JAX package's, line for line."""
    names = ["edge_key", "wedge_key", "triangle_key", "star3_key", "path4_key",
             "random_labels", "_support", "_eval_edge", "_eval_wedge", "_eval_triangle",
             "_eval_star3", "_eval_path4"]
    for name in names:
        assert inspect.getsource(getattr(F, name)) == inspect.getsource(getattr(JF, name))
    assert inspect.getsource(F._Ctx.nbrs) == inspect.getsource(JF._Ctx.nbrs)


# exhaustive patterns -> the engine's query with the same (induced) count
ENGINE_QUERY = {"triangle": "triangle", "3-chain": "three-chain-induced",
                "4-clique": "4-clique", "5-clique": "5-clique", "tailed-triangle": "paw",
                "diamond": "diamond", "4-cycle": "4-cycle", "4-star": "4-star",
                "4-path": "4-path"}


@pytest.mark.parametrize("pattern", list(PATTERN_CHECKS))
def test_exhaustive_count_equals_jax_and_engine(pattern):
    """Planted 6- and 5-cliques make every pattern's count non-zero."""
    g, jg = _pair(clique_planted(40, 100, (6, 5), seed=2), 40)
    got = exhaustive_count(g, pattern)
    assert got == jexhaustive_count(jg, pattern) > 0
    assert got == Miner(g, device="cpu").count(ENGINE_QUERY[pattern])
@pytest.mark.parametrize("device_compact", [True, False])
def test_fsm_pattern_feed_and_triangle_lists_equal_jax(device_compact):
    """The FSM feed alone and in a mixed [count, emit] forest, and
    triangle_list / triangle_list_host, equal the JAX package's."""
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    m = Miner(g, device="cpu", device_compact=device_compact)
    jm = JMiner(jg, backend="xla", device_compact=device_compact)
    feed = apps.fsm_pattern_feed(g, miner=m)[0]
    np.testing.assert_array_equal(feed, np.asarray(japps.fsm_pattern_feed(jg, miner=jm)[0]))
    count, rows = m.run_plans([m.compile("triangle"), *apps.FSM_FEED_PLANS])
    jcount, jrows = jm.run_plans([jm.compile("triangle"), *japps.FSM_FEED_PLANS])
    assert count == jcount == len(rows) == 11502
    np.testing.assert_array_equal(rows, feed)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    assert _state(m) == _state(jm)
    host = apps.triangle_list_host(g)
    np.testing.assert_array_equal(host, japps.triangle_list_host(jg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        listed = apps.triangle_list(g, device="cpu")
        jlisted = japps.triangle_list(jg)
    np.testing.assert_array_equal(listed, np.asarray(jlisted))
    # the host oracle enumerates pair by pair, the engine by degree bucket:
    # the same triangles, each once
    assert sorted(map(tuple, host)) == sorted(map(tuple, listed))


def test_module_waves_equal_jax():
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    chunk = 256
    got = list(engine.edge_wave(g, chunk))
    want = list(jengine.edge_wave(jg, chunk))
    assert len(got) == len(want) > 1
    for (w, n), (jw, jn) in zip(got, want):
        assert n == jn
        np.testing.assert_array_equal(w.rows.numpy(), np.asarray(jw.rows))
        np.testing.assert_array_equal(w.verts, jw.verts)
        for bounded in (True, False):
            np.testing.assert_array_equal(engine.expand_count(g, w, bounded).numpy(),
                                          np.asarray(jengine.expand_count(jg, jw, bounded)))
        for a, b in zip(engine.expand(g, w), jengine.expand(jg, jw)):
            np.testing.assert_array_equal(a, b)
    edges = engine.half_edges(g)
    for a, b in zip(engine.pair_chunks(g, edges, chunk), jengine.pair_chunks(jg, edges, chunk)):
        assert a[:2] == b[:2] and a[4] == b[4]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    for (ra, rb, v0, v1, n), (jra, jrb, jv0, jv1, jn) in zip(
            engine.pair_wave(g, edges, chunk), jengine.pair_wave(jg, edges, chunk)):
        np.testing.assert_array_equal(ra.numpy(), np.asarray(jra))
        np.testing.assert_array_equal(rb.numpy(), np.asarray(jrb))
        assert n == jn
    wave = engine.Wave(rows=np.asarray(want[0][0].rows)[:300], verts=want[0][0].verts[:300])
    for (w, n), (jw, jn) in zip(engine.wave_chunks(wave, 128),
                                jengine.wave_chunks(jengine.Wave(wave.rows, wave.verts), 128)):
        assert n == jn
        np.testing.assert_array_equal(w.rows, jw.rows)
        np.testing.assert_array_equal(w.verts, jw.verts)


def test_deprecated_shims_warn_and_count():
    """Each one-shot shim warns and returns the JAX package's count, on one
    shared session per (graph, config, device)."""
    g = get_dataset("email-eu-core", 0.25)
    calls = [(apps.triangle_count, (), 11502), (apps.clique_count, (4,), 10622),
             (apps.three_chain_count, (True,), 138732),
             (apps.tailed_triangle_count, (), 1769583),
             (apps.pattern_count, ("diamond",), 151646)]
    for fn, args, want in calls:
        with pytest.warns(DeprecationWarning, match="hold a session"):
            assert fn(g, *args, device="cpu") == want, fn.__name__
    with pytest.warns(DeprecationWarning):
        assert apps.three_motif(g, device="cpu") == {"triangle": 11502, "chain": 138732}
    with pytest.warns(DeprecationWarning):
        motifs = apps.four_motif(g, device="cpu")
    with pytest.warns(DeprecationWarning):
        assert apps.four_motif(g, fused=False, device="cpu") == motifs
    assert motifs["4-cycle"] == 161630
    assert apps.shared_session(g, device="cpu") is apps.shared_session(g, device="cpu")
    assert apps.shared_session(g, device="cpu") is not \
        apps.shared_session(g, device_compact=False, device="cpu")


def test_launch_mine_fsm_apps(capsys):
    from repro_torch.launch import mine
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    labels = random_labels(g.num_vertices, 2, seed=1)
    jm = JMiner(jg, backend="xla")
    for app, fn in (("FSM", jfsm), ("sFSM", jsfsm)):
        want = len(fn(jg, labels, 100, miner=jm))
        got = mine.main(["--app", app, "--dataset", "email-eu-core", "--scale", "0.25",
                         "--device", "cpu", "--support", "100", "--labels", "2"])
        assert got == {"frequent_patterns": want} and want > 0
        assert f"{app} = {got}" in capsys.readouterr().out


def test_launch_mine_exhaustive_trace_and_session_stats(capsys, tmp_path):
    import json

    from repro_torch.launch import mine
    out = tmp_path / "trace.json"
    got = mine.main(["--app", "T", "--dataset", "citeseer", "--device", "cpu",
                     "--exhaustive", "triangle", "--trace", str(out), "--session-stats"])
    text = capsys.readouterr().out
    assert got == 3 and "exhaustive(triangle) = 3" in text
    assert "spans ->" in text and "mining_queries 1" in text
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"query", "compile", "execute", "feed", "L2:count", "dispatch",
            "finalize"} <= names
    # --shards 8: the same count over an 8-way mesh of the CPU
    assert mine.main(["--app", "T", "--dataset", "citeseer", "--device", "cpu",
                      "--shards", "8"]) == 3
    assert "[mine] mesh: 8-way ({'mine': 8}) over cpu" in capsys.readouterr().out
