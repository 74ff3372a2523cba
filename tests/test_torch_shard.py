"""The port's sharded miner (``repro_torch.mining.shard``) against the JAX
package's, on CPU meshes (``device="cpu"``: S shards on the CPU).

The sharded contract (``repro.mining.shard``, ``tests/test_shard_mining.py``):

  * **feed** — ``shard_edge_steps`` yields the JAX package's arrays, step
    for step, and on full email-eu-core benchmarks/baseline.json's per-shard
    feed items;
  * **parity** — counts, aggregates and embedding multisets at mesh 2 and 8
    equal the unsharded session's (and the JAX package's);
  * **counters** — ci_gate.py's ``measure_sharded`` and ``measure_telemetry``
    mixes give baseline.json's ``sharded.email-eu-core@0.25.*`` and
    ``telemetry.email-eu-core@0.25.mesh8.*`` values, the goldens of
    tests/test_obs.py hold at mesh 8, and a repeated sharded pass rebuilds
    nothing;
  * **degeneracy** — mesh 1 is the plain runner; unsupported modes raise.

The JAX package's own sharded runner needs eight JAX devices, which a test
process that has already started JAX cannot get; ``test_sharded_counters_
equal_jax_sharded_runner`` runs it in a subprocess with eight host devices.
"""
import argparse
import copy
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graph import build_csr as jbuild_csr
from repro.mining.session import Miner as JMiner
from repro.mining.shard import shard_edge_steps as jshard_edge_steps
from repro_torch import Miner, MinerConfig
from repro_torch.distributed import make_mining_mesh
from repro_torch.graph import build_csr, edge_list, edge_weights, get_dataset, with_edge_values
from repro_torch.graph.generators import clique_planted, erdos_renyi, powerlaw_cluster
from repro_torch.launch import mine
from repro_torch.mining.engine import WaveRunner, _pow2cap, choose_chunk, half_edges
from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
from repro_torch.mining.session import ExecutableCache, mesh_signature
from repro_torch.mining.shard import FEED_PARTITIONS, ShardedWaveRunner, shard_edge_steps
from repro_torch.obs import Telemetry
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EXACT = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                    / "baseline.json").read_text())["exact"]
MOTIFS = list(FOUR_MOTIF_SHAPES)
# the parity tests' chunk: counts do not depend on it, and at the default
# (16384 on these graphs) every shard of every lockstep step would pad its
# rows to 16384; baseline.json's counters are taken at the default
CHUNK = 128
QUERIES = ("triangle", "4-clique", "three-chain", "tailed-triangle", "diamond", "paw")


def wheel(n: int) -> np.ndarray:
    """Hub 0 joined to every rim vertex 1..n-1, the rim a cycle: one extreme
    hub, the feed-skew stress shape of tests/test_shard_mining.py."""
    hub = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    rim = np.stack([np.arange(1, n), np.arange(2, n + 1)], axis=1)
    rim[-1, 1] = 1
    return np.concatenate([hub, rim], axis=0)


# tests/test_shard_mining.py's graphs, as (edges, vertices)
EDGES = {"er": (erdos_renyi(60, 240, seed=3), 60),
         "plc": (powerlaw_cluster(50, 4, seed=5), 50),
         "cliq": (clique_planted(45, 120, (6, 5), seed=1), 45),
         "wheel": (wheel(40), 40)}
GRAPHS = {name: build_csr(e, v) for name, (e, v) in EDGES.items()}
TINY = build_csr(erdos_renyi(6, 5, seed=2), 6)       # fewer half-edges than shards


def sharded(g, shards: int = 8, chunk: int | None = CHUNK, **kw) -> Miner:
    return Miner(g, device="cpu", mesh=shards, chunk=chunk, **kw)


@pytest.fixture(scope="module")
def unsharded():
    """Per graph: the unsharded session's counts of QUERIES, 5-clique and
    the 4-motif batch."""
    out = {}
    for name, g in GRAPHS.items():
        m = Miner(g, device="cpu", chunk=CHUNK)
        out[name] = {q: m.count(q) for q in QUERIES + ("5-clique",)}
        out[name]["4M"] = m.count_many(MOTIFS)
    return out


# ------------------------------------------------------------------ feed

@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", FEED_PARTITIONS)
@pytest.mark.parametrize("name", list(EDGES))
def test_feed_equals_jax(name, mode, shards):
    """Every step's (cap, v0, v1, n) equals the JAX package's, array for
    array, in both orientations, at a chunk small enough for many steps."""
    jg = jbuild_csr(*EDGES[name])
    for symmetric in (True, False):
        got = list(shard_edge_steps(GRAPHS[name], 16, shards, symmetric, mode))
        want = list(jshard_edge_steps(jg, 16, shards, symmetric, mode))
        assert len(got) == len(want) > 0
        for (cap, *arrays), (jcap, *jarrays) in zip(got, want):
            assert cap == jcap
            for x, y in zip(arrays, jarrays):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_feed_on_full_email_eu_core_equals_baseline_json():
    g = get_dataset("email-eu-core", 1.0)
    chunk = min(choose_chunk(g.padded_max_degree), 1 << 15)
    items = np.zeros(8, np.int64)
    for *_, n in shard_edge_steps(g, chunk, 8):
        items += n
    assert items.tolist() == EXACT["sharded.email-eu-core.feed_items_8"]
    assert bool(items.max() / max(items.min(), 1) <= 2.0) is \
        EXACT["sharded.email-eu-core.feed_balance_ratio_le_2"] is True


def test_feed_rejects_an_unknown_partition_mode():
    with pytest.raises(ValueError):
        list(shard_edge_steps(GRAPHS["er"], 64, 8, mode="hashed"))


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("name", list(EDGES))
def test_sharded_counts_bit_identical(name, shards, unsharded):
    m = sharded(GRAPHS[name], shards)
    queries = QUERIES + (("5-clique",) if name == "cliq" else ())
    assert {q: m.count(q) for q in queries} == {q: unsharded[name][q] for q in queries}
    assert m.count_many(MOTIFS) == unsharded[name]["4M"]


@pytest.mark.parametrize("name", ["plc", "wheel"])
def test_sharded_counts_equal_jax_miner(name, unsharded):
    jm = JMiner(jbuild_csr(*EDGES[name]), backend="xla")
    for q in ("triangle", "4-clique", "diamond", "paw"):
        assert unsharded[name][q] == jm.count(q), q
    m = sharded(GRAPHS[name])
    assert [m.count(q) for q in ("triangle", "4-clique", "diamond", "paw")] == \
        [unsharded[name][q] for q in ("triangle", "4-clique", "diamond", "paw")]


def _rows(t: np.ndarray) -> np.ndarray:
    return t[np.lexsort(t.T[::-1])]


def test_sharded_embeddings_enumerate_the_jax_multiset():
    """Rows come shard after shard, so only the multiset is the JAX
    package's (and the unsharded session's)."""
    g = GRAPHS["cliq"]
    got = sharded(g).embeddings("4-clique")
    want = JMiner(jbuild_csr(*EDGES["cliq"]), backend="xla").embeddings("4-clique")
    assert got.dtype == np.int32 and got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(_rows(got), _rows(np.asarray(want)))
    np.testing.assert_array_equal(_rows(got), _rows(Miner(g, device="cpu", chunk=CHUNK)
                                                    .embeddings("4-clique")))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_sharded_aggregates_bit_identical_on_dyadic_weights(op):
    """Each shard's leaf reduces with the op; the shards' values meet on
    shard 0's device (a dead shard holds the op's identity)."""
    g = with_edge_values(GRAPHS["plc"], edge_weights(edge_list(GRAPHS["plc"]), seed=0))
    m1, m8 = Miner(g, device="cpu", chunk=CHUNK), sharded(g)
    for q in ("triangle", "diamond", "paw"):
        assert m8.aggregate(q, op) == m1.aggregate(q, op), q
    if op == "sum":
        assert m8.aggregate_many(MOTIFS, op) == m1.aggregate_many(MOTIFS, op)


def counter_mix(Miner, g, gw) -> dict:
    """T, 4C, the 4-motif batch, paw and diamond embeddings and the weighted
    triangle sum and max on one mesh-8 session a graph (``gw``: ``g``
    weighted): the counts, the runner's stats and its level calls. Run as
    it stands by the port and, in a subprocess, by the JAX package."""
    m, w = Miner(g, mesh=8, chunk=128), Miner(gw, mesh=8, chunk=128)
    counts = [m.count("triangle"), m.count("4-clique"),
              [int(c) for c in m.count_many(list(FOUR_MOTIF_SHAPES))],
              len(m.embeddings("paw")), len(m.embeddings("diamond")),
              float(w.aggregate("triangle", "sum")), float(w.aggregate("triangle", "max"))]
    return {"counts": counts,
            "runner": [dict(s.runner.stats) for s in (m, w)],
            "level_execs": [sorted((str(k), v) for k, v in s.runner.level_execs.items())
                            for s in (m, w)]}


JAX_SIDE = """
import json, sys
import numpy as np
from repro.graph import build_csr
from repro.graph.csr import with_edge_values
from repro.mining.plan import FOUR_MOTIF_SHAPES
from repro.mining.session import Miner
import jax
assert jax.device_count() >= 8, jax.devices()
data = np.load(sys.argv[1])
out = {}
for name in sys.argv[2].split(","):
    g = build_csr(data[name + "_edges"], int(data[name + "_n"]))
    out[name] = counter_mix(Miner, g, with_edge_values(g, data[name + "_w"]))
print(json.dumps(out, default=int))
"""


def test_sharded_counters_equal_jax_sharded_runner(tmp_path):
    """The port's mesh-8 runner against the JAX package's ShardedWaveRunner
    on test_shard_mining.py's four graphs: counts, aggregates, every runner
    counter (host syncs, device compactions, items, psum reductions, the
    per-shard feed) and the level calls of count, expand, emit, forest and
    aggregate levels, equal."""
    arrays = {}
    for name, (edges, n) in EDGES.items():
        arrays.update({f"{name}_edges": edges, f"{name}_n": np.int64(n),
                       f"{name}_w": edge_weights(edge_list(GRAPHS[name]), seed=0)})
    np.savez(tmp_path / "graphs.npz", **arrays)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")])}
    script = inspect.getsource(counter_mix) + JAX_SIDE
    run = subprocess.run([sys.executable, "-c", script, str(tmp_path / "graphs.npz"),
                          ",".join(EDGES)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    want = json.loads(run.stdout.splitlines()[-1])

    def port_miner(g, **kw):
        return Miner(g, device="cpu", **kw)
    for name, g in GRAPHS.items():
        gw = with_edge_values(g, edge_weights(edge_list(g), seed=0))
        got = json.loads(json.dumps(counter_mix(port_miner, g, gw), default=int))
        assert got == want[name], name


# ------------------------------------------------------------------ baseline.json

def _dispatch_allowance(miner, g) -> int:
    """bench_mining.py's allowance: feed degree buckets x call sites."""
    deg = g.degrees.numpy()
    buckets = len(np.unique([_pow2cap(max(int(d), 1)) for d in deg[deg > 0]])) or 1
    sites = sum(len(miner.compile(q).ops)
                for q in ("triangle", "three-chain", "tailed-triangle", "4-clique"))
    forest = miner.schedule(MOTIFS)
    stack = list(forest.symmetric_roots) + list(forest.directed_roots)
    while stack:
        node = stack.pop()
        sites += 1
        stack.extend(node.children)
    return buckets * sites


def _gate_mix(m) -> dict:
    """bench_mining.py's (and ci_gate.py's telemetry) mix: T, TC, TT, 4C,
    then the 4-motifs through count_many."""
    res = {"T": m.count("triangle"), "TC": m.count("three-chain"),
           "TT": m.count("tailed-triangle"), "4C": m.count("4-clique")}
    res.update(zip(MOTIFS, m.count_many(MOTIFS)))
    return res


@pytest.fixture(scope="module")
def gate8():
    """An untraced mesh-8 session at the default chunk after one pass of the
    mix: (session, counts, a copy of its stats, its level calls)."""
    m = sharded(get_dataset("email-eu-core", 0.25), chunk=None)
    counts = _gate_mix(m)
    return m, counts, copy.deepcopy(m.stats), sum(m.runner.level_execs.values())


def test_sharded_mix_equals_baseline_json(gate8):
    """ci_gate.py:measure_sharded: bench_mining.py's mix at mesh 1, and
    twice at mesh 8; the second pass's counters (mesh 1 makes the same
    level calls every pass)."""
    tag = "sharded.email-eu-core@0.25"
    g = get_dataset("email-eu-core", 0.25)
    one = Miner(g, device="cpu")
    counts1 = _gate_mix(one)
    dispatches1 = sum(one.runner.level_execs.values())
    m, first, stats, execs = gate8
    assert _gate_mix(m) == first == counts1 == EXACT[f"{tag}.counts"]
    rs, was = m.stats["runner"], stats["runner"]
    dispatches8 = sum(m.runner.level_execs.values()) - execs
    assert {"1": dispatches1, "8": dispatches8} == \
        EXACT[f"{tag}.dispatches_per_pass"] == {"1": 43, "8": 16}
    assert rs["psum_reductions"] - was["psum_reductions"] == \
        EXACT[f"{tag}.psum_reductions_per_pass"] == 12
    assert [v - w for v, w in zip(rs["shard_feed_items"], was["shard_feed_items"])] == \
        EXACT[f"{tag}.shard_feed_items_8"]
    assert m.stats["rebuilds"] - stats["rebuilds"] == EXACT[f"{tag}.retraces_second_pass"] == 0
    ok = dispatches8 <= dispatches1 / 8 + _dispatch_allowance(m, g)
    assert ok is EXACT[f"{tag}.dispatch_scaling_ok"] is True


def test_sharded_telemetry_equals_baseline_json(gate8):
    """ci_gate.py:measure_telemetry at mesh 8: a traced session against the
    untraced one of ``gate8`` after the same pass."""
    tag = "telemetry.email-eu-core@0.25.mesh8"
    tel = Telemetry(enabled=True)
    traced = sharded(get_dataset("email-eu-core", 0.25), chunk=None, telemetry=tel)
    counts = _gate_mix(traced)
    _, plain_counts, plain_stats, _ = gate8
    reg, rs, sess = tel.metrics, dict(traced.runner.stats), traced.stats
    keys = ("queries", "plan_hits", "plan_misses", "schedule_hits", "schedule_misses")
    fam = reg.series("shard_feed_items")
    reg_ok = all(reg.value(k) == v for k, v in rs.items() if not isinstance(v, list)) \
        and [fam[(("shard", s),)].value for s in range(8)] == rs["shard_feed_items"] \
        and all(reg.value(k) == sess[k] for k in keys)
    by_cat: dict = {}
    for sp in tel.tracer.spans():
        if sp.cat != "host":    # the port's host spans: no JAX counterpart
            by_cat[sp.cat] = by_cat.get(sp.cat, 0) + 1
    assert reg_ok is EXACT[f"{tag}.registry_equals_legacy"] is True
    assert (counts == plain_counts and sess == plain_stats) is \
        EXACT[f"{tag}.enabled_disabled_parity"] is True
    assert rs == EXACT[f"{tag}.runner_stats"]
    assert rs["host_syncs"] == 19 and rs["items"] == 369821
    assert {k: sess[k] for k in keys} == EXACT[f"{tag}.session_counters"]
    assert by_cat == EXACT[f"{tag}.span_counts"] == {"dispatch": 16, "level": 22, "span": 20}


def test_sharded_stats_goldens_of_test_obs():
    m = sharded(build_csr(powerlaw_cluster(110, 5, seed=7), 110), chunk=None)
    assert m.count("triangle") == 440
    assert m.count("4-clique") == 78
    rs = dict(m.runner.stats)
    assert rs["psum_reductions"] == 2
    assert rs["shard_feed_items"] == [160, 160, 158, 158, 158, 158, 158, 158]
    fam = m.telemetry.metrics.series("shard_feed_items")
    assert [fam[(("shard", s),)].value for s in range(8)] == rs["shard_feed_items"]


# ------------------------------------------------------------------ contracts

def test_sharded_repeats_rebuild_nothing():
    m = sharded(GRAPHS["er"])
    first, batch = m.count("triangle"), m.count_many(MOTIFS)
    built, psums = m.stats["rebuilds"], m.stats["runner"]["psum_reductions"]
    assert built > 0 and psums > 0
    assert m.count("triangle") == first and m.count_many(MOTIFS) == batch
    assert m.stats["rebuilds"] == built
    assert m.stats["runner"]["psum_reductions"] > psums


def test_sharded_feed_accounts_for_every_edge():
    m = sharded(GRAPHS["wheel"])
    m.count("triangle")                      # one symmetric feed pass
    items = m.stats["runner"]["shard_feed_items"]
    assert sum(items) == half_edges(GRAPHS["wheel"]).shape[0]
    assert min(items) > 0                    # the hub's run was dealt out


def test_sharded_handles_more_shards_than_edges():
    """TINY has fewer half-edges than shards: some shards mine nothing but
    carry bound-0 padding."""
    m1 = Miner(TINY, device="cpu", chunk=CHUNK)
    assert sharded(TINY).count("triangle") == m1.count("triangle")
    assert sharded(TINY).count_many(MOTIFS) == m1.count_many(MOTIFS)


def test_contiguous_feed_partition_is_exact_too(unsharded):
    m = sharded(GRAPHS["wheel"], feed_partition="contiguous")
    assert m.count("triangle") == unsharded["wheel"]["triangle"]
    assert m.count_many(MOTIFS) == unsharded["wheel"]["4M"]


@pytest.mark.parametrize("mesh", [None, 1])
def test_mesh_one_is_the_plain_unsharded_runner(mesh, unsharded):
    m = Miner(GRAPHS["er"], device="cpu", mesh=mesh, chunk=CHUNK)
    assert type(m.runner) is WaveRunner
    # a CPU session's signature names the CPU, cards or none
    assert m.mesh is None and m.stats["mesh"] == mesh_signature(None, "cpu") == ("cpu", 1)
    assert m.count("triangle") == unsharded["er"]["triangle"]


def test_mesh_signature_isolates_sharded_executables():
    mesh = make_mining_mesh(2, device_type="cpu")
    assert dict(mesh.shape) == {"mine": 2}
    assert mesh_signature(mesh) != mesh_signature(None)
    assert ("mine", 2) in mesh_signature(mesh)
    assert mesh_signature(make_mining_mesh(2, "other", device_type="cpu")) != \
        mesh_signature(mesh)
    assert ExecutableCache(mesh=mesh).prefix != ExecutableCache().prefix
    m = sharded(GRAPHS["er"], 2)
    m.count("triangle")
    assert m.stats["mesh"] == mesh_signature(m.mesh)
    assert all(k[:1] == (mesh_signature(m.mesh),) and ("mesh", "mine", 2) == k[4:7]
               for k in m.exec_cache._entries)


def test_sharded_runner_rejects_unsupported_modes():
    g, mesh, cache = GRAPHS["er"], make_mining_mesh(2, device_type="cpu"), ExecutableCache()
    for kw in ({"device_compact": False}, {"record": True}, {"axis": "model"},
               {"feed_partition": "hashed"}):
        with pytest.raises(ValueError):
            ShardedWaveRunner(g, mesh, cache, **kw)


def test_mesh_wider_than_the_visible_cards_raises():
    """Without devices=, a card mesh takes distinct cards only (here there
    are none); repeating a card is explicit."""
    with pytest.raises(ValueError, match="devices="):
        make_mining_mesh(torch.cuda.device_count() + 1)
    mesh = make_mining_mesh(8, devices=["cpu"] * 8)
    assert len(mesh.devices) == 8 and set(mesh.devices) == {mesh.devices[0]}
    with pytest.raises(ValueError, match="device type"):
        Miner(GRAPHS["er"], device="cpu", mesh=2, mesh_devices=("cuda:0", "cuda:0"))


def test_from_args_and_launcher_take_shards(capsys):
    assert MinerConfig.from_args(argparse.Namespace(shards=8)).mesh == 8
    assert MinerConfig.from_args(argparse.Namespace(shards=1)).mesh is None
    res = mine.main(["--app", "4C", "--dataset", "email-eu-core", "--scale", "0.25",
                     "--device", "cpu", "--shards", "8", "--session-stats",
                     "--partitions", "4"])
    out = capsys.readouterr().out
    assert res == EXACT["sharded.email-eu-core@0.25.counts"]["4C"] == 10622
    assert "[mine] mesh: 8-way ({'mine': 8})" in out
    assert "[mine] shards: feed items [527, 527, 527, 527, 527, 527, 527, 526]" in out
    assert "1 psum reductions" in out and "[mine] 4 partitions: load imbalance" in out
