"""Graph mining launcher — one ``Miner`` session serving one app.

  python -m repro_torch.launch.mine --app T --dataset mico
  python -m repro_torch.launch.mine --app 4C --dataset email-eu-core \\
      --scale 0.25 --device cpu --baseline
  python -m repro_torch.launch.mine --app FSM --dataset email-eu-core --support 100

Runs on the CUDA device unless ``--device cpu``. ``--baseline`` checks the
result against the scalar InHouseAutoMine enumeration (T, TC, TT, TM, 4C,
5C; keep it off 5C on large graphs: it is exponential).

The motif batches run their patterns through one plan forest
(``Miner.count_many``): TM, the 3-motifs (triangle and induced
three-chain), and 4M, the six 4-motifs. F3M and F4M are the same batches
with the forest's sharing report printed first; ``--independent`` runs a
batch pattern by pattern instead, and ``--check`` (F3M, F4M) asserts that
the fused counts equal the independent ones, and on a graph of at most 256
vertices that F4M's equal the brute-force census of every vertex quadruple
(``mining.reference.four_motif_counts`` on the session's device).

FSM and sFSM mine frequent labelled subgraphs of up to three edges
(``mining.fsm``, MNI support and embedding-count support) with
``--labels`` random vertex labels (``random_labels(V, labels, seed=1)``)
at ``--support``; their triangles come from the session's emit plan.
``--exhaustive PATTERN`` also counts PATTERN by the GRAMER-style
exhaustive check (``mining.exhaustive``; exponential, small graphs only).

Session flags (``launch.cli.add_session_args``, read by
``MinerConfig.from_args``): ``--chunk``; ``--trace OUT.json`` turns span
tracing on and writes the run's span tree as Chrome-trace JSON, its ``ts``
on ``torch.profiler``'s clock (with ``--torch-profile LOGDIR`` too, after
that trace's ``baseTimeNanoseconds``, so the two files' events merge into
one Perfetto timeline), and prints the spans' host self time by span name
(the level spans' own Python, ``dispatch``'s torch ops, ``launch``,
``sync``, ``slice``, ``upload``), the top six; ``--session-stats`` prints
the cache counters and the metrics registry; ``--shards N`` mines over an
N-way mesh (the first N
cards, or N times the CPU with ``--device cpu``; ``Miner(mesh_devices=)``
puts several shards on one card) and ``--session-stats`` then prints the
per-shard feed items and the cross-shard reductions. ``--partitions N``
prints the load imbalance of a degree-balanced N-way vertex partition
(``distributed.fault_tolerance``). ``--torch-profile LOGDIR`` wraps the
query in ``torch.profiler`` (``Telemetry.torch_profile``: CPU activity, and
CUDA activity on a card) and writes its Chrome trace to LOGDIR/trace.json.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.distributed.fault_tolerance import balanced_vertex_partition
from repro_torch.graph.datasets import DATASETS, dataset_stats, get_dataset
from repro_torch.mining import baseline, exhaustive, reference
from repro_torch.mining.fsm import fsm, random_labels, sfsm
from repro_torch.mining.plan import FOUR_MOTIF_SHAPES, THREE_CHAIN_INDUCED, TRIANGLE
from repro_torch.mining.session import Miner, MinerConfig

from .cli import add_graph_args, add_session_args

# single-pattern apps
PATTERN_APPS = {"T": "triangle", "TS": "triangle-nested", "TC": "three-chain",
                "TT": "tailed-triangle", "4C": "4-clique", "5C": "5-clique",
                "DM": "diamond", "CY": "4-cycle", "PW": "paw", "P4": "4-path",
                "S4": "4-star"}
# motif batches through the plan forest; F3M / F4M print its sharing report
BATCH_APPS = ("TM", "F3M", "4M", "F4M")
# frequent subgraph mining: MNI support, and GRAMER's count support
FSM_APPS = {"FSM": fsm, "sFSM": sfsm}
APPS = [*PATTERN_APPS, *BATCH_APPS, *FSM_APPS]
THREE_MOTIF_QUERIES = (TRIANGLE, THREE_CHAIN_INDUCED)
BASELINES = {
    "T": lambda g: baseline.triangle_count(g),
    "TC": lambda g: baseline.three_chain_count(g, induced=True),
    "TT": lambda g: baseline.tailed_triangle_count(g),
    "TM": lambda g: baseline.three_motif(g),
    "4C": lambda g: baseline.clique_count(g, 4),
    "5C": lambda g: baseline.clique_count(g, 5),
}


def run_app(app: str, miner: Miner, fused: bool = True, support: int = 100,
            labels=None):
    """Serve one app code from the session: an int, for a motif batch a
    dict of counts by pattern, for FSM / sFSM the number of frequent
    patterns."""
    if app in FSM_APPS:
        res = FSM_APPS[app](miner.graph, labels, support, miner=miner)
        return {"frequent_patterns": len(res)}
    if app in ("TM", "F3M"):
        if fused:
            t, chains = miner.count_many(list(THREE_MOTIF_QUERIES))
        else:
            t, chains = (miner.count(q) for q in THREE_MOTIF_QUERIES)
        return {"triangle": t, "chain": chains}
    if app in ("4M", "F4M"):
        names = list(FOUR_MOTIF_SHAPES)
        if fused:
            return dict(zip(names, miner.count_many(names)))
        return {name: miner.count(name) for name in names}
    return miner.count(PATTERN_APPS[app])


def forest_report(app: str, miner: Miner) -> str:
    """Static sharing of the F3M / F4M batch: ops per level, plans against
    the forest, and feed passes, independent against fused."""
    queries = list(FOUR_MOTIF_SHAPES) if app == "F4M" else list(THREE_MOTIF_QUERIES)
    st = miner.schedule(queries).sharing_stats()
    levels = sorted({lv for _, lv in st["plan_ops"]})
    per_level = " ".join(
        f"L{lv}:{sum(v for (_, l2), v in st['plan_ops'].items() if l2 == lv)}"
        f"->{sum(v for (_, l2), v in st['forest_ops'].items() if l2 == lv)}"
        for lv in levels)
    return (f"{st['plans']} plans, ops {per_level}, feed passes "
            f"{st['feed_passes']['independent']}->{st['feed_passes']['fused']}")


def run_baseline(app: str, g) -> int:
    return BASELINES[app](g)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", choices=APPS, default="T")
    add_graph_args(ap, choices=list(DATASETS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to mine on (cuda, or cpu for the "
                         "kernels' plain torch versions)")
    ap.add_argument("--baseline", action="store_true",
                    help="also run InHouseAutoMine (scalar CPU) and compare "
                         f"({', '.join(BASELINES)})")
    ap.add_argument("--independent", action="store_true",
                    help="run a motif batch pattern by pattern instead of "
                         "through the fused plan forest")
    ap.add_argument("--check", action="store_true",
                    help="F3M/F4M: assert fused counts == independent "
                         "per-pattern counts (and F4M's == the brute-force "
                         "census when the graph has at most 256 vertices)")
    ap.add_argument("--support", type=int, default=100,
                    help="FSM/sFSM: minimum support of a frequent pattern")
    ap.add_argument("--labels", type=int, default=4,
                    help="FSM/sFSM: number of random vertex labels")
    ap.add_argument("--exhaustive", default="", metavar="PATTERN",
                    help="also count PATTERN by the GRAMER-style exhaustive check ("
                         + ", ".join(exhaustive.PATTERN_CHECKS) + ")")
    ap.add_argument("--partitions", type=int, default=0,
                    help="print degree-balanced partition stats (straggler)")
    add_session_args(ap)
    ap.add_argument("--torch-profile", default="", metavar="LOGDIR",
                    help="wrap the query in torch.profiler (CPU, and CUDA on a "
                         "card); its Chrome trace is written to LOGDIR/trace.json")
    args = ap.parse_args(argv)
    if args.baseline and args.app not in BASELINES:
        ap.error(f"no scalar baseline for {args.app}; "
                 f"have {', '.join(BASELINES)}")
    if args.exhaustive and args.exhaustive not in exhaustive.PATTERN_CHECKS:
        ap.error(f"--exhaustive {args.exhaustive}: pick from "
                 f"{', '.join(exhaustive.PATTERN_CHECKS)}")

    g = get_dataset(args.dataset, scale=args.scale)
    print(f"[mine] {args.dataset} x{args.scale}: {dataset_stats(g)}")
    miner = Miner(g, MinerConfig.from_args(args))
    telemetry = miner.telemetry
    if miner.mesh is not None:
        print(f"[mine] mesh: {args.shards}-way ({dict(miner.mesh.shape)}) over "
              f"{', '.join(str(d) for d in dict.fromkeys(miner.mesh.devices))}")
    labels = random_labels(g.num_vertices, args.labels, seed=1) \
        if args.app in FSM_APPS else None
    if args.app in ("F3M", "F4M"):
        print(f"[mine] forest: {forest_report(args.app, miner)}")
    t0 = time.perf_counter()
    # ints on the host: the device work is done
    with telemetry.torch_profile(args.torch_profile or None, miner.config.device):
        res = run_app(args.app, miner, fused=not args.independent, support=args.support,
                      labels=labels)
    dt = time.perf_counter() - t0
    print(f"[mine] {args.app} = {res}  ({dt:.2f}s on {args.device}, "
          f"runner {miner.stats['runner']})")
    if args.trace:
        base = 0
        if args.torch_profile:      # the profile's frame: one timeline
            prof = json.loads((Path(args.torch_profile) / "trace.json").read_text())
            base = int(prof.get("baseTimeNanoseconds", 0))
        path = telemetry.write_trace(args.trace, base_ns=base)
        top = sorted(telemetry.tracer.level_seconds().items(), key=lambda kv: -kv[1])[:6]
        print(f"[mine] trace: {sum(1 for _ in telemetry.tracer.spans())} spans -> "
              f"{path}; host self-time " + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in top))
    if args.check and args.app in ("F3M", "F4M"):
        indep = run_app(args.app, miner, fused=False)
        if indep != res:
            raise SystemExit(f"[mine] fused {res} != independent {indep}")
        print("[mine] fused == independent per-plan counts OK")
        if args.app == "F4M" and g.num_vertices <= 256:
            census = reference.four_motif_counts(g, device=miner.config.device)
            if census != res:
                raise SystemExit(f"[mine] fused {res} != brute-force census {census}")
            print("[mine] fused == brute-force census OK")
    if args.baseline:
        t0 = time.perf_counter()
        rb = run_baseline(args.app, g)
        if rb != res:
            raise SystemExit(f"[mine] baseline {rb} != engine {res}")
        print(f"[mine] baseline(InHouseAutoMine) = {rb} "
              f"({time.perf_counter() - t0:.2f}s)")
    if args.exhaustive:
        t0 = time.perf_counter()
        n = exhaustive.exhaustive_count(g, args.exhaustive)
        print(f"[mine] exhaustive({args.exhaustive}) = {n} "
              f"({time.perf_counter() - t0:.2f}s, GRAMER-style)")
    if args.partitions:
        degrees = g.degrees.cpu().numpy()
        assign = balanced_vertex_partition(degrees, args.partitions)
        loads = np.bincount(assign, weights=degrees.astype(np.float64) ** 2,
                            minlength=args.partitions)
        print(f"[mine] {args.partitions} partitions: load imbalance "
              f"max/mean = {loads.max() / loads.mean():.3f}")
    if args.session_stats:
        st = miner.stats
        print(f"[mine] session: {st['queries']} queries, exec cache "
              f"{st['exec_cache']['hits']} hits / {st['exec_cache']['misses']} builds, "
              f"plan cache {st['plan_hits']}/{st['plan_misses']}, schedule cache "
              f"{st['schedule_hits']}/{st['schedule_misses']}")
        if miner.mesh is not None:
            rs = st["runner"]
            fi = rs["shard_feed_items"]
            print(f"[mine] shards: feed items {fi} (max/min {max(fi) / max(min(fi), 1):.2f}), "
                  f"{rs['psum_reductions']} psum reductions")
        print("[mine] metrics:")
        print(telemetry.prometheus_text(), end="")
    return res


if __name__ == "__main__":
    main()
