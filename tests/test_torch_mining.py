"""The port's mining path (repro_torch.Miner) against the JAX package's.

Counts and the engine counters whose meaning carries over must be equal on
the same graphs; the port must import neither JAX nor the JAX package; the
framework-free modules it copies must stay equal to their originals.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graph import get_dataset as jget_dataset
from repro.mining import baseline as jbaseline
from repro.mining import engine as jengine
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.graph import get_dataset
from repro_torch.mining import baseline, engine
from repro_torch.mining.plan import TRIANGLE, clique_pattern, compile_pattern
from repro_torch.mining.session import MinerConfig

SRC = Path(__file__).resolve().parents[1] / "src"
GRAPHS = [("citeseer", 1.0), ("email-eu-core", 0.25)]
# SUB and general levels: three-chain(-induced) counts at a SUB level;
# diamond, 4-star, 4-cycle, paw and 4-path run SUB and general levels
LEVEL_QUERIES = ["three-chain", "three-chain-induced", "diamond", "4-star",
                 "4-cycle", "paw", "4-path"]
QUERIES = ["triangle", "4-clique", "5-clique", "tailed-triangle", "triangle-nested",
           *LEVEL_QUERIES]
COUNTERS = ("exec_misses", "exec_hits", "items", "device_compactions",
            "level_kernel_dispatches")


def runner_counters(miner) -> dict:
    st = dict(miner.stats["runner"])
    out = {k: st[k] for k in COUNTERS}
    out["feed_chunks"] = miner.metrics.counter("feed_chunks").value
    return out


@pytest.mark.parametrize("name,scale", GRAPHS)
@pytest.mark.parametrize("chunk", [None, 128])
def test_counts_and_counters_equal_jax_miner(name, scale, chunk):
    """chunk=128 splits every wave into several chunks with padded tails."""
    tm = Miner(get_dataset(name, scale), device="cpu", chunk=chunk)
    jm = JMiner(jget_dataset(name, scale), backend="xla", chunk=chunk)
    for q in QUERIES:
        assert tm.count(q) == jm.count(q), q
        assert runner_counters(tm) == runner_counters(jm), q


def test_reference_counts_on_email_eu_core():
    m = Miner(get_dataset("email-eu-core", 0.25), device="cpu")
    assert [m.count(q) for q in ("triangle", "4-clique", "5-clique")] == \
        [11502, 10622, 5051]
    assert m.stats["runner"]["items"] == 11502 + 11502 + 10622


def test_counts_equal_scalar_baseline_and_reference_baseline():
    g = get_dataset("email-eu-core", 0.25)
    jg = jget_dataset("email-eu-core", 0.25)
    m = Miner(g, device="cpu")
    assert baseline.triangle_count(g) == jbaseline.triangle_count(jg) == m.count("triangle")
    assert baseline.clique_count(g, 4) == jbaseline.clique_count(jg, 4) \
        == m.count("4-clique")


def test_planted_cliques_equal_jax_miner_and_baseline():
    """Planted 5-, 6- and 7-cliques make every clique count non-zero."""
    from repro.graph.csr import build_csr as jbuild_csr
    from repro_torch.graph.csr import build_csr
    from repro_torch.graph.generators import clique_planted
    edges = clique_planted(300, 900, (5, 6, 7), seed=4)
    g, jg = build_csr(edges, 300), jbuild_csr(edges, 300)
    tm, jm = Miner(g, device="cpu", chunk=256), JMiner(jg, backend="xla", chunk=256)
    for k, q in ((3, "triangle"), (4, "4-clique"), (5, "5-clique")):
        got = tm.count(q)
        assert got == jm.count(q) == baseline.clique_count(g, k) > 0, q
        assert runner_counters(tm) == runner_counters(jm), q


def test_repeated_query_rebuilds_nothing():
    m = Miner(get_dataset("email-eu-core", 0.25), device="cpu")
    first = [m.count(q) for q in ("triangle", "5-clique")]
    rebuilds = m.stats["rebuilds"]
    assert [m.count(q) for q in ("triangle", "5-clique")] == first
    st = m.stats
    assert st["rebuilds"] == rebuilds and st["plan_hits"] == 2
    assert st["exec_cache"]["entries"] == rebuilds


def test_engine_feed_equals_reference():
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    np.testing.assert_array_equal(engine.half_edges(g), jengine.half_edges(jg))
    np.testing.assert_array_equal(engine.directed_edges(g), jengine.directed_edges(jg))
    for chunk in (128, 1024):
        got = list(engine.edge_chunks(g, chunk))
        want = list(jengine.edge_chunks(jg, chunk))
        assert len(got) == len(want)
        for (c, v0, v1, n), (wc, wv0, wv1, wn) in zip(got, want):
            assert (c, n) == (wc, wn)
            np.testing.assert_array_equal(v0, wv0)
            np.testing.assert_array_equal(v1, wv1)
    for cap in (128, 2048, 18560, 32768):
        assert engine.choose_chunk(cap) == jengine.choose_chunk(cap)
    degs = np.array([0, 1, 127, 128, 129, 300, 4096, 4097, 18517])
    assert engine._pow2caps(degs).tolist() == [jengine._pow2cap(max(int(d), 1))
                                               for d in degs]


@pytest.mark.parametrize("name,scale", GRAPHS)
def test_unfused_levels_equal_jax_miner(name, scale):
    """fused_level=False: one mark launch per reference of a general level;
    counts and counters (level_kernel_dispatches too) equal the JAX
    engine's, and the count equals the fused run's."""
    g, jg = get_dataset(name, scale), jget_dataset(name, scale)
    tm = Miner(g, device="cpu", fused_level=False)
    jm = JMiner(jg, backend="xla", fused_level=False)
    fused = Miner(g, device="cpu")
    for q in LEVEL_QUERIES:
        got = tm.count(q)
        assert got == jm.count(q) == fused.count(q), q
        assert runner_counters(tm) == runner_counters(jm), q


def test_unfused_level_dispatches_one_mark_per_reference():
    """4-cycle runs a SUB expand level, then a general count level with k = 2
    references: unfused, each call of the count level launches k = 2 marks
    instead of one k-reference kernel, so the dispatches rise by k - 1 = 1
    per count-level call and nothing else changes."""
    g = get_dataset("email-eu-core", 0.25)
    plan = Miner(g, device="cpu").compile("4-cycle")
    assert [(op.kind, engine.WaveRunner._fused_shape(op), len(op.inter) + len(op.sub))
            for op in plan.ops] == [("expand", "sub", 1), ("count", None, 2)]
    runs = {}
    for fl in (True, False):
        m = Miner(g, device="cpu", fused_level=fl)
        runs[fl] = (m.count("4-cycle"), dict(m.stats["runner"]))
    (c1, st1), (c0, st0) = runs[True], runs[False]
    assert c1 == c0 == 161630
    count_calls = st1["level_kernel_dispatches"] - st1["device_compactions"]
    assert count_calls > 0
    assert st0["level_kernel_dispatches"] - st1["level_kernel_dispatches"] == count_calls
    assert {k: v for k, v in st0.items() if k != "level_kernel_dispatches"} == \
        {k: v for k, v in st1.items() if k != "level_kernel_dispatches"}


def test_baseline_json_counts_on_email_eu_core():
    """The JAX package's recorded session counts (benchmarks/baseline.json)."""
    exact = json.loads((SRC.parent / "benchmarks" / "baseline.json").read_text())["exact"]
    want = exact["email-eu-core@0.25.session.counts"]
    m = Miner(get_dataset("email-eu-core", 0.25), device="cpu")
    got = {"TC": m.count("three-chain"), "TT": m.count("tailed-triangle")}
    got.update({q: m.count(q) for q in ("diamond", "4-star", "4-cycle", "paw", "4-path")})
    assert got == {"TC": want["TC"], "TT": want["TT"],
                   **{q: want["4M"][q] for q in ("diamond", "4-star", "4-cycle", "paw",
                                                 "4-path")}}
    assert got["TC"] == 138732 and got["4-path"] == 3252244


@pytest.mark.parametrize("name,scale", GRAPHS)
def test_three_chain_equals_scalar_baselines_and_closed_form(name, scale):
    """Induced three-chains = Σ_v C(d_v, 2) − 3·triangles."""
    g, jg = get_dataset(name, scale), jget_dataset(name, scale)
    m = Miner(g, device="cpu")
    got = m.count("three-chain-induced")
    d = g.degrees.numpy().astype(np.int64)
    assert got == baseline.three_chain_count(g, induced=True) \
        == jbaseline.three_chain_count(jg, induced=True) \
        == int((d * (d - 1) // 2).sum()) - 3 * m.count("triangle")
    assert baseline.three_chain_count(g) == jbaseline.three_chain_count(jg) \
        == int((d * (d - 1) // 2).sum())
    assert baseline.tailed_triangle_count(g) == jbaseline.tailed_triangle_count(jg) \
        == m.count("tailed-triangle")
    assert baseline.three_motif(g) == jbaseline.three_motif(jg) \
        == {"triangle": m.count("triangle"), "chain": got}


@pytest.mark.parametrize("query", ["triangle-emit", "4-clique-emit"])
def test_emit_plans_equal_jax_runner(query):
    """A compiled emit plan run on the runner: the embedding matrix equals
    the JAX engine's row for row, and so do the counters."""
    from repro.mining import plan as JP
    name, _ = query.rsplit("-", 1)
    pat = TRIANGLE if name == "triangle" else clique_pattern(4)
    jpat = JP.TRIANGLE if name == "triangle" else JP.clique_pattern(4)
    m = Miner(get_dataset("citeseer", 1.0), device="cpu")
    jm = JMiner(jget_dataset("citeseer", 1.0), backend="xla")
    got = m.runner.run(compile_pattern(pat, emit=True))
    want = np.asarray(jm.runner.run(JP.compile_pattern(jpat, emit=True)))
    assert got.dtype == np.int32 and got.shape == want.shape == (
        (3, 3) if name == "triangle" else (0, 4))
    np.testing.assert_array_equal(got, want)
    assert dict(m.stats["runner"]) == dict(jm.stats["runner"])
    assert m.runner.level_execs == jm.runner.level_execs


def test_miner_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = get_dataset("citeseer", 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Miner(g)
    with pytest.raises(RuntimeError):
        Miner(g, MinerConfig(device="cuda"))


def test_launch_mine_runs_on_cpu_with_baseline(capsys):
    from repro_torch.launch import mine
    got = mine.main(["--app", "4C", "--dataset", "email-eu-core", "--scale", "0.25",
                     "--device", "cpu", "--baseline"])
    assert got == 10622
    out = capsys.readouterr().out
    assert "4C = 10622" in out and "baseline(InHouseAutoMine) = 10622" in out


@pytest.mark.parametrize("app,want", [("TC", 138732), ("TT", 1769583)])
def test_launch_mine_level_apps_with_baseline(capsys, app, want):
    from repro_torch.launch import mine
    got = mine.main(["--app", app, "--dataset", "email-eu-core", "--scale", "0.25",
                     "--device", "cpu", "--baseline"])
    assert got == want
    out = capsys.readouterr().out
    assert f"{app} = {want}" in out and f"baseline(InHouseAutoMine) = {want}" in out


@pytest.mark.parametrize("app,want", [("DM", 151646), ("CY", 161630), ("PW", 1035535),
                                      ("S4", 1652486)])
def test_launch_mine_motif_apps(capsys, app, want):
    from repro_torch.launch import mine
    args = ["--app", app, "--dataset", "email-eu-core", "--scale", "0.25", "--device", "cpu"]
    assert mine.main(args) == want
    capsys.readouterr()
    with pytest.raises(SystemExit):
        mine.main(args + ["--baseline"])
    out, err = capsys.readouterr()
    assert "no scalar baseline" in err and out == ""   # refused before mining


def _port_modules() -> list[str]:
    pkg = SRC / "repro_torch"
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "repro_torch.kernels.intersect" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_source_names_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f


# copied modules and the lines each may change (original -> port)
COPIED = {
    "graph/generators.py": {}, "mining/plan.py": {}, "mining/forest.py": {},
    "obs/registry.py": {}, "obs/trace.py": {}, "obs/export.py": {},
    "launch/cli.py": {'                         "(on CPU set XLA_FLAGS="':
                      '                         "(the first N cards; N times the CPU with "',
                      '                         "--xla_force_host_platform_device_count=N)")':
                      '                         "--device cpu)")'},
    "mining/exhaustive.py": {"from repro.graph.csr import CSRGraph":
                             "from repro_torch.graph.csr import CSRGraph"},
    "distributed/fault_tolerance.py": {},
}


@pytest.mark.parametrize("path", list(COPIED))
def test_copied_modules_equal_their_originals(path):
    original = (SRC / "repro" / path).read_text().splitlines()
    assert sum(line in COPIED[path] for line in original) == len(COPIED[path])
    assert (SRC / "repro_torch" / path).read_text().splitlines() == \
        [COPIED[path].get(line, line) for line in original]
