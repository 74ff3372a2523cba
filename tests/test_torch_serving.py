"""The port's mining service (``repro_torch.serving``) against the JAX
package's (``repro.serving``), on the CPU (``device="cpu"`` sessions).

  * **counterparts** of tests/test_serving.py: cross-request batching,
    result cache, admission control, steady state under threaded load, the
    mixed pool (mesh 8 on the CPU, which the JAX suite skips without eight
    devices), the public surface and its deprecated shims, value traffic;
  * **side by side** — one request stream through the JAX service and the
    port's: results, tick summaries, service counters, cache snapshots,
    retraces and metric names equal;
  * **baseline.json** — benchmarks/bench_serving.py's batching, cache,
    mesh-8 and load facts on email-eu-core 0.25 give the exact
    ``serving.email-eu-core@0.25.*`` keys;
  * **launcher** — ``python -m repro_torch.launch.serve --mine``;
  * **one-shots** — the runner's ``count_edges``/``clique``/
    ``three_chain_induced``/``tailed_triangle`` equal the JAX runner's.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import pytest

from repro.graph import build_csr as jbuild_csr
from repro.mining import Miner as JMiner
from repro.serving import MiningService as JMiningService
from repro_torch.graph import (build_csr, edge_list, edge_weights, get_dataset,
                               with_edge_values)
from repro_torch.graph.generators import erdos_renyi, powerlaw_cluster
from repro_torch.launch import serve
from repro_torch.mining import FOUR_MOTIF_SHAPES, Miner, MinerConfig
from repro_torch.mining.engine import WaveRunner
from repro_torch.mining.session import ExecutableCache
from repro_torch.serving import (LoadGenerator, MiningService, RequestRejected,
                                 RequestTimeout, ServiceConfig, WorkerSpec)
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
EDGES, EDGES2 = erdos_renyi(60, 240, seed=3), powerlaw_cluster(50, 4, seed=5)
G, G2 = build_csr(EDGES, 60), build_csr(EDGES2, 50)
JG, JG2 = jbuild_csr(EDGES, 60), jbuild_csr(EDGES2, 50)
CPU = (WorkerSpec("default", MinerConfig(device="cpu")),)

MIXES = [("triangle",), ("three-chain",), ("tailed-triangle",),
         ("4-clique",), ("paw", "diamond", "4-cycle")]


@pytest.fixture(scope="module")
def ref():
    return Miner(G, device="cpu")


def service(g=G, **kw) -> MiningService:
    return MiningService(g, workers=CPU, **kw)


# ---------------------------------------------------------------------------
# cross-request batching: merged schedule, bit-identical results
# ---------------------------------------------------------------------------


def test_tick_merges_requests_bit_identical(ref):
    svc = service(cache_results=False)
    handles = [svc.submit(qs) for qs in MIXES]
    tick = svc.tick()
    assert tick["requests"] == len(MIXES)
    assert tick["executed"] == len(MIXES)
    fp = tick["feed_passes"]
    assert fp["fused"] < fp["independent"]
    for h, qs in zip(handles, MIXES):
        assert h.done and not h.from_cache
        assert h.result() == ref.count_many(list(qs))


def test_single_query_convenience(ref):
    assert service().query("triangle") == ref.count("triangle")


def test_tick_on_empty_queue_is_noop():
    tick = service().tick()
    assert tick["requests"] == 0 and tick["executed"] == 0


# ---------------------------------------------------------------------------
# result cache: hits, and invalidation on graph-version bump
# ---------------------------------------------------------------------------


def test_cache_hit_and_version_invalidation():
    svc = service(cache_results=True)
    first = svc.query(("triangle", "paw"))
    warm = svc.cache.snapshot()
    assert warm["hits"] == 0 and warm["misses"] == 2

    h = svc.submit(("triangle", "paw"))
    tick = svc.tick()
    assert tick["executed"] == 0
    assert h.from_cache and h.result() == first
    assert svc.cache.snapshot()["hits"] == 2

    svc.set_graph(G2)
    snap = svc.cache.snapshot()
    assert snap["entries"] == 0 and snap["invalidations"] == warm["entries"]
    assert svc.query("triangle") == Miner(G2, device="cpu").count("triangle")


def test_partial_cache_hit_shrinks_batch(ref):
    svc = service(cache_results=True)
    svc.query(("triangle",))
    h = svc.submit(("triangle", "4-cycle"))
    before = svc.cache.snapshot()["hits"]
    svc.tick()
    assert h.result() == [ref.count("triangle"), ref.count("4-cycle")]
    assert svc.cache.snapshot()["hits"] == before + 1


# ---------------------------------------------------------------------------
# admission control: queue-full rejection, deadline timeout
# ---------------------------------------------------------------------------


def test_queue_full_rejects_at_submit(ref):
    svc = service(max_in_flight=1)
    admitted = svc.submit(("triangle",))
    rejected = svc.submit(("paw",))
    assert rejected.done
    with pytest.raises(RequestRejected):
        rejected.result()
    assert svc.stats["service_rejected"] == 1
    svc.run_until_idle()
    assert admitted.result() == [ref.count("triangle")]


def test_deadline_timeout_completes_with_typed_error():
    svc = service(timeout_s=0.01)
    h = svc.submit(("triangle",))
    time.sleep(0.05)
    tick = svc.tick()
    assert tick["timeouts"] == 1 and tick["executed"] == 0
    assert h.done
    with pytest.raises(RequestTimeout):
        h.result()
    late = svc.submit(("triangle",), timeout_s=60.0)
    svc.run_until_idle()
    assert late.state == "done"


# ---------------------------------------------------------------------------
# steady state: zero rebuilds under threaded concurrent load
# ---------------------------------------------------------------------------


def test_steady_state_zero_retraces_under_concurrent_load(ref):
    svc = service(cache_results=False)
    [svc.submit(qs) for qs in MIXES]
    svc.run_until_idle()
    before = svc.stats["retraces"]

    results: list = []

    def client(i):
        h = svc.submit(MIXES[i % len(MIXES)])
        results.append((i, h.result(timeout=60.0)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    while svc.pending or any(t.is_alive() for t in threads):
        if not svc.tick()["requests"]:
            time.sleep(0.001)
    for t in threads:
        t.join()
    assert len(results) == 10
    for i, res in results:
        assert res == ref.count_many(list(MIXES[i % len(MIXES)]))
    assert svc.stats["retraces"] == before


# ---------------------------------------------------------------------------
# mixed sharded/unsharded worker pool: a mesh of 8 on the CPU
# ---------------------------------------------------------------------------


def test_mixed_pool_routes_by_class_and_counts_agree(ref):
    svc = MiningService(G, workers=(
        WorkerSpec("default", MinerConfig(device="cpu")),
        WorkerSpec("bulk", MinerConfig(device="cpu", mesh=8, chunk=128))))
    assert svc.pool.worker("bulk").mesh is not None
    assert svc.pool.worker("default").mesh is None
    a = svc.submit(("triangle", "paw"))
    b = svc.submit(("triangle", "paw"), traffic_class="bulk")
    svc.tick()
    assert a.result() == b.result() == ref.count_many(["triangle", "paw"])
    c = svc.submit(("triangle",), traffic_class="nope")
    svc.run_until_idle()
    assert c.result() == [ref.count("triangle")]


# ---------------------------------------------------------------------------
# stable public surface + deprecated shims
# ---------------------------------------------------------------------------


def test_public_surface_exports():
    import repro.mining as jmining
    import repro.serving as jserving
    import repro_torch.mining as mining
    import repro_torch.serving as serving
    assert serving.__all__ == jserving.__all__
    assert all(getattr(serving, name) is not None for name in serving.__all__)
    for name in ("Miner", "MinerConfig", "MiningService", "Pattern",
                 "Motif", "compile_pattern"):
        assert name in mining.__all__
        assert getattr(mining, name) is not None
    assert mining.MiningService is MiningService
    # the JAX surface, less the networkx oracles (``reference``)
    assert set(jmining.__all__) - set(mining.__all__) == {"reference"}
    assert mining._APPS_REEXPORTS == jmining._APPS_REEXPORTS
    assert list(mining.FOUR_MOTIFS) == list(jmining.FOUR_MOTIFS)


def test_service_config_sugar_matches_explicit_config():
    explicit = MiningService(G, ServiceConfig(max_in_flight=2, workers=CPU))
    sugar = service(max_in_flight=2)
    assert explicit.config == sugar.config


def test_apps_one_shots_warn_deprecation(ref):
    import repro_torch.mining as mining
    with pytest.warns(DeprecationWarning, match="triangle_count is deprecated"):
        n = mining.triangle_count(G, device="cpu")
    assert n == ref.count("triangle")
    with pytest.warns(DeprecationWarning, match="four_motif"):
        mining.four_motif(G, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert mining.shared_session(G, device="cpu").count("triangle") == n
    for name in mining._APPS_REEXPORTS:
        assert getattr(mining, name) is getattr(mining.apps, name)


# ---------------------------------------------------------------------------
# value traffic: aggregate requests on the ``values`` class
# ---------------------------------------------------------------------------


def _weighted_g():
    return with_edge_values(G, edge_weights(edge_list(G), seed=7))


def test_aggregate_requests_route_and_match_sessions():
    from repro_torch.serving import VALUES_CLASS
    gw = _weighted_g()
    svc = service(gw)
    counts = svc.submit(["triangle", "4-clique"])
    sums = svc.submit(["triangle", "4-clique"], aggregate="sum")
    maxes = svc.submit("triangle", aggregate="max")
    tick = svc.tick()
    assert tick["executed"] == 3
    assert sums.traffic_class == VALUES_CLASS
    assert counts.traffic_class != VALUES_CLASS
    m = Miner(gw, device="cpu")
    assert counts.result(0) == [m.count("triangle"), m.count("4-clique")]
    assert sums.result(0) == [m.aggregate("triangle", op="sum"),
                              m.aggregate("4-clique", op="sum")]
    assert maxes.result(0)[0] == m.aggregate("triangle", op="max")


def test_aggregate_cache_keys_never_collide_with_counts():
    gw = _weighted_g()
    svc = service(gw)
    count = svc.query("triangle")
    total = svc.query("triangle", aggregate="sum")
    assert count != total
    c2 = svc.submit("triangle")
    s2 = svc.submit("triangle", aggregate="sum")
    tick = svc.tick()
    assert tick["cached"] == 2 and tick["executed"] == 0
    assert c2.result(0)[0] == count and c2.from_cache
    assert s2.result(0)[0] == total and s2.from_cache
    r_min = svc.submit("triangle", aggregate="min")
    assert svc.tick()["executed"] == 1
    assert r_min.result(0)[0] == Miner(gw, device="cpu").aggregate("triangle", op="min")


def test_aggregate_groups_batch_like_count_groups():
    gw = _weighted_g()
    svc = service(gw, cache_results=False)
    handles = [svc.submit(qs, aggregate="sum") for qs in MIXES]
    tick = svc.tick()
    assert tick["executed"] == len(MIXES)
    fp = tick["feed_passes"]
    assert fp["fused"] < fp["independent"]
    m = Miner(gw, device="cpu")
    for h, qs in zip(handles, MIXES):
        assert h.result(0) == [m.aggregate(q, op="sum") for q in qs]


def test_aggregate_submit_rejects_unknown_op():
    with pytest.raises(ValueError, match="aggregate must be one of"):
        service(_weighted_g()).submit("triangle", aggregate="avg")


# ---------------------------------------------------------------------------
# side by side: the JAX service and the port's on one request stream
# ---------------------------------------------------------------------------


SERVICE_COUNTERS = ("service_requests", "service_completed", "service_rejected",
                    "service_timeouts", "service_failed", "service_ticks",
                    "service_queries", "service_feed_passes_independent",
                    "service_feed_passes_fused")


def _drive(svc, g2) -> dict:
    """Two passes of MIXES (the second served from cache), a graph swap,
    then a third pass; every observable of the service along the way."""
    out = {"ticks": [], "results": [], "cache": []}
    for g in (None, None, g2):
        if g is not None:
            svc.set_graph(g)
        handles = [svc.submit(qs) for qs in MIXES]
        out["ticks"].append(svc.tick())
        out["results"].append([(h.state, h.from_cache, h.result(0)) for h in handles])
        out["cache"].append(svc.cache.snapshot())
    st = svc.stats
    out["stats"] = {k: st[k] for k in SERVICE_COUNTERS + ("version", "retraces", "pending")}
    out["workers"] = {tc: {k: w[k] for k in ("queries", "retraces", "exec_entries", "mesh")}
                      for tc, w in st["workers"].items()}
    out["metrics"] = sorted(re.findall(r"^# TYPE (\S+) (\S+)$", svc.prometheus_text(), re.M))
    return out


def test_service_equals_jax_service():
    want = _drive(JMiningService(JG, cache_results=True), JG2)
    got = _drive(service(cache_results=True), G2)
    assert got == want


# ---------------------------------------------------------------------------
# benchmarks/baseline.json's exact serving.email-eu-core@0.25.* keys
# ---------------------------------------------------------------------------


BENCH_MIXES = [("triangle",), ("three-chain",), ("tailed-triangle",), ("4-clique",),
               tuple(FOUR_MOTIF_SHAPES)]
BENCH_LABELS = ["T", "TC", "TT", "4C"] + list(FOUR_MOTIF_SHAPES)


def _submit_mix(svc, classes) -> list:
    return [svc.submit(qs, traffic_class=tc) for qs, tc in zip(BENCH_MIXES, classes)]


def _batching(svc, classes, rounds: int = 2) -> dict:
    """bench_serving.batching_report: the mix as concurrent requests, one
    tick a round; counts repeat and steady rounds rebuild nothing."""
    first, steady = None, 0
    for _ in range(rounds):
        before = svc.stats["retraces"]
        handles = _submit_mix(svc, classes)
        tick = svc.tick()
        res = dict(zip(BENCH_LABELS, [v for h in handles for v in h.result(0)]))
        if first is None:
            first = res
        else:
            assert res == first
            steady += svc.stats["retraces"] - before
    fp = tick["feed_passes"]
    return {"counts": first, "feed_passes": [fp["independent"], fp["fused"]],
            "sharing_ok": fp["fused"] < fp["independent"], "steady_retraces": steady,
            "workers": sorted(svc.stats["workers"])}


def _cache(g) -> dict:
    """bench_serving.cache_report: the mix twice on a cached service, then
    a version bump."""
    svc = MiningService(g, workers=CPU, cache_results=True)
    classes = ["default"] * len(BENCH_MIXES)
    _submit_mix(svc, classes)
    svc.run_until_idle()
    warm = svc.cache.snapshot()
    handles = _submit_mix(svc, classes)
    tick = svc.tick()
    assert all(h.from_cache for h in handles)
    snap = svc.cache.snapshot()
    svc.set_graph(g)
    after = svc.cache.snapshot()
    return {"first_pass_misses": warm["misses"], "entries": snap["entries"],
            "second_pass_hits": snap["hits"] - warm["hits"],
            "cached_tick_executed": tick["executed"],
            "invalidations": after["invalidations"], "entries_after_bump": after["entries"]}


def test_serving_baseline_keys():
    """The exact keys of ci_gate.py's measure_serving(sharded=True), from
    bench_serving.py's phases on the port: batching (2 rounds: warm-up and
    one steady round), cache, the mixed pool with a mesh-8 bulk worker on
    the CPU, and the burst load, run on the batching service once its
    rounds have built every executable (its retraces and feed passes are
    read as deltas over the load alone). The ratio keys are wall ratios
    and are not held."""
    exact = json.loads((ROOT / "benchmarks" / "baseline.json").read_text())["exact"]
    tag = "serving.email-eu-core@0.25."
    want = {k[len(tag):]: v for k, v in exact.items() if k.startswith(tag)}
    g = get_dataset("email-eu-core", 0.25)
    svc = MiningService(g, workers=CPU, cache_results=False)
    b = _batching(svc, ["default"] * len(BENCH_MIXES))
    got = {"counts": b["counts"], "batch_requests": len(BENCH_MIXES),
           "feed_passes": b["feed_passes"], "sharing_ok": b["sharing_ok"],
           "steady_retraces": b["steady_retraces"], "cache": _cache(g)}
    before = svc.stats
    res = LoadGenerator(svc, list(zip(BENCH_MIXES, ["default"] * len(BENCH_MIXES))),
                        requests=24, clients=4, qps=None).run()
    assert res["completed"] == 24
    got["load_retraces"] = res["retraces"] - before["retraces"]
    got["load_sharing_ok"] = (res["feed_passes"]["fused"] - before["service_feed_passes_fused"]
                              < res["feed_passes"]["independent"]
                              - before["service_feed_passes_independent"])
    # the bulk worker at chunk 512: none of the mesh8 keys depends on the
    # chunk, and at the default (16384 here) each of the eight shards pads
    # every lockstep step to it
    mesh = MiningService(g, cache_results=False, workers=(
        CPU[0], WorkerSpec("bulk", MinerConfig(device="cpu", mesh=8, chunk=512))))
    bm = _batching(mesh, ["default"] * (len(BENCH_MIXES) - 1) + ["bulk"])
    got.update({"mesh8.counts_parity": bm["counts"] == b["counts"],
                "mesh8.workers": bm["workers"], "mesh8.sharing_ok": bm["sharing_ok"],
                "mesh8.steady_retraces": bm["steady_retraces"]})
    assert got == want


# ---------------------------------------------------------------------------
# the launcher, and the runner's one-shots
# ---------------------------------------------------------------------------


def test_launch_serve_mine_rounds(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mine", "email-eu-core",
         "--scale", "0.25", "--device", "cpu", "--rounds", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "T=11502 4C=10622" in out.stdout
    assert re.search(r"^\[serve\] round 1: .* 0 retraces$", out.stdout, re.M)
    assert "2 fused feed passes vs 6 independent" in out.stdout
    # without --mine it decodes (the JAX launcher's LLM decoding), as
    # tests/test_system.py runs the JAX launcher
    serve.main(["--arch", "rwkv6-3b", "--batch", "2", "--tokens", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^\[serve\] rwkv6-3b: 2x8 tokens in [\d.]+s = [\d.]+ tok/s$", out, re.M)
    assert re.search(r"^\[serve\] sample: \[0(, \d+){8}\]$", out, re.M)


def test_runner_one_shots_equal_jax_runner():
    from repro.mining.engine import WaveRunner as JWaveRunner
    edges = erdos_renyi(140, 900, seed=13)
    g, jg = build_csr(edges, 140), jbuild_csr(edges, 140)
    ours, theirs = WaveRunner(g, ExecutableCache(device="cpu")), JWaveRunner(jg)

    def calls(r):
        return [r.clique(4), r.count_edges()] + [
            r.count_edges(sym, bounded) for sym in (True, False) for bounded in (True, False)
        ] + [r.clique(3), r.clique(5), r.three_chain_induced(), r.tailed_triangle()]
    got, want = calls(ours), calls(theirs)
    assert got == want and got[:2] == [14, 401]
    assert dict(ours.stats) == dict(theirs.stats)
    with pytest.raises(ValueError, match="k >= 3"):
        ours.clique(2)
    # the sharded runner inherits them
    sharded, jr = Miner(G, device="cpu", mesh=8, chunk=128).runner, JMiner(JG).runner
    assert [sharded.clique(4), sharded.count_edges(), sharded.tailed_triangle()] == \
        [jr.clique(4), jr.count_edges(), jr.tailed_triangle()]
