"""Quickstart, on the PyTorch/CUDA port: the IntersectX stream ISA + the
Miner session in 60 seconds.

  PYTHONPATH=src python examples/quickstart_torch.py               # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain torch versions

The counterpart of ``examples/quickstart.py``, line for line, through
``repro_torch`` alone: it prints the same lines, and every count in them is
the JAX example's.
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import isa, make_stream, to_host, s_nestinter
from repro_torch.graph import build_csr, neighbors_stream
from repro_torch.graph.generators import erdos_renyi
from repro_torch.mining import Miner, MinerConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the hand kernels) or cpu (their plain torch versions)")
dev = ap.parse_args().device

# --- streams are first-class: Table I instructions as library calls -------
a = make_stream([1, 3, 5, 7, 9], values=[1., 2., 3., 4., 5.], device=dev)
b = make_stream([3, 4, 5, 9, 11], values=[10., 20., 30., 40., 50.], device=dev)
print("S_INTER    :", to_host(isa.s_inter(a, b)))          # [3 5 9]
print("S_INTER R3 :", to_host(isa.s_inter(a, b, bound=6)))  # early termination
print("S_SUB      :", to_host(isa.s_sub(a, b)))
print("S_VINTER   :", float(isa.s_vinter(a, b, op="mac")))  # sparse dot
print("S_FETCH EOS:", int(isa.s_fetch(a, 99)))              # 2^31-1

# --- a graph is a CSR of streams; S_NESTINTER is the mining inner loop ----
g = build_csr(erdos_renyi(500, 3000, seed=0), 500).to(dev)
n0 = neighbors_stream(g, 0)
print("S_NESTINTER(N(0)) =", int(s_nestinter(g, n0)))

# --- mining is a session: one Miner owns the graph, queries are cheap -----
# compile (pattern -> plan), schedule (matching-order search + forest),
# execute (device-resident waves) — every stage cached for the session.
m = Miner(g, device=dev)
print("triangles          :", m.count("triangle"))
print("triangles (nested) :", m.count("triangle-nested"))
print("3-chains (induced) :", m.count("three-chain"))
print("tailed triangles   :", m.count("tailed-triangle"))
print("4-cliques          :", m.count("4-clique"))

# the six connected 4-vertex motifs, one fused pass (shared-prefix forest
# built by the automatic matching-order search — no hand-tuned schedules)
names = ["4-clique", "diamond", "4-cycle", "paw", "4-path", "4-star"]
print("4-motifs (fused)   :", dict(zip(names, m.count_many(names))))

# embeddings come from the same session (emit plan, device compaction)
print("triangle list      :", m.embeddings("triangle").shape)

# repeated queries are pure cache hits: nothing is rebuilt from here on (the
# port's ``rebuilds``, the JAX session's ``retraces``)
before = m.stats["rebuilds"]
m.count("triangle")
m.count_many(names)
print("retraces on repeat :", m.stats["rebuilds"] - before)

# --- weighted mining: the SVPU value plane (paper §IV-E) ------------------
# one f32 weight per edge (aligned with the CSR keys, staged once per
# session); the same fused plans aggregate embedding weights — SUM/MAX/MIN
# of the per-embedding products of pattern-edge weights — on the
# membership kernels' value lanes, with no extra feed pass.
from repro_torch.graph import edge_weights, with_edge_values
from repro_torch.graph.csr import edge_list

gw = with_edge_values(g, edge_weights(edge_list(g), seed=1))
mw = Miner(gw, device=dev)
print("weighted triangles :", mw.aggregate("triangle", op="sum"))
print("heaviest triangle  :", mw.aggregate("triangle", op="max"))
print("weighted (batched) :", mw.aggregate_many(["triangle", "4-clique"]))
before = mw.stats["rebuilds"]
mw.aggregate("triangle", op="sum")
print("retraces on repeat :", mw.stats["rebuilds"] - before)

# --- observability: trace a query, see where its time went ----------------
# a Telemetry(enabled=True) session records a span tree per query (query ->
# compile/schedule/execute -> per-level -> per-dispatch, and the host spans
# launch/sync/slice/upload; host wall time, no synchronize added); counters
# live in the same registry the stats dicts above are views of. write_trace()
# exports Chrome-trace JSON for ui.perfetto.dev (as `launch/mine.py --trace`).
from repro_torch.obs import Telemetry

tel = Telemetry(enabled=True)
mt = Miner(g, telemetry=tel, device=dev)
mt.count("4-clique")
q = tel.tracer.last("query")
print("traced query       :", f"{q.seconds * 1e3:.1f}ms,",
      sum(1 for s in q.walk() if s.cat != "host"), "spans,",   # as the JAX tracer's
      len(q.find("dispatch")), "dispatches")
top = sorted(tel.tracer.level_seconds().items(),
             key=lambda kv: -kv[1])[:3]
print("hottest spans      :", {k: f"{v * 1e3:.1f}ms" for k, v in top})

# --- concurrent traffic: a MiningService over a pool of sessions ----------
# submit() is thread-safe and non-blocking; each tick() merges the queued
# requests into ONE forest schedule per traffic class (cross-request
# sharing), serves repeats from a graph-version-keyed result cache, and
# applies admission control (max_in_flight, per-request deadlines).
from repro_torch.serving import MiningService, WorkerSpec

svc = MiningService(g, workers=(WorkerSpec("default", MinerConfig(device=dev)),))
r1 = svc.submit(("triangle", "paw"))      # two concurrent requests ...
r2 = svc.submit(("triangle", "4-cycle"))  # ... sharing the triangle prefix
tick = svc.tick()
print("service tick       :", tick["requests"], "requests merged,",
      "feed passes", tick["feed_passes"]["independent"], "->",
      tick["feed_passes"]["fused"])
print("request results    :", r1.result(), r2.result())
print("cached repeat      :", svc.query("triangle"),
      f"(hits={svc.cache.snapshot()['hits']})")

# several cards? the same session mines data-parallel over a mesh of them —
# counts are bit-identical
if dev != "cpu" and torch.cuda.device_count() > 1:
    ms = Miner(g, mesh=torch.cuda.device_count())
    print("triangles (mesh)   :", ms.count("triangle"))
