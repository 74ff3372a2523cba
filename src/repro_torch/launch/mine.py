"""Graph mining launcher — one ``Miner`` session serving one app.

  python -m repro_torch.launch.mine --app T --dataset mico
  python -m repro_torch.launch.mine --app 4C --dataset email-eu-core \\
      --scale 0.25 --device cpu --baseline

Runs on the CUDA device unless ``--device cpu``. ``--baseline`` checks the
result against the scalar InHouseAutoMine enumeration (T, TC, TT, TM, 4C,
5C; keep it off 5C on large graphs: it is exponential).

The motif batches run their patterns through one plan forest
(``Miner.count_many``): TM, the 3-motifs (triangle and induced
three-chain), and 4M, the six 4-motifs. F3M and F4M are the same batches
with the forest's sharing report printed first; ``--independent`` runs a
batch pattern by pattern instead, and ``--check`` (F3M, F4M) asserts that
the fused counts equal the independent ones. The JAX launcher's ``--check``
also holds F4M to a brute-force census (``repro.mining.reference``, which
needs networkx); the port leaves that census out.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.graph.datasets import DATASETS, dataset_stats, get_dataset
from repro_torch.mining import baseline
from repro_torch.mining.plan import FOUR_MOTIF_SHAPES, THREE_CHAIN_INDUCED, TRIANGLE
from repro_torch.mining.session import Miner, MinerConfig

from .cli import add_graph_args

# single-pattern apps
PATTERN_APPS = {"T": "triangle", "TS": "triangle-nested", "TC": "three-chain",
                "TT": "tailed-triangle", "4C": "4-clique", "5C": "5-clique",
                "DM": "diamond", "CY": "4-cycle", "PW": "paw", "P4": "4-path",
                "S4": "4-star"}
# motif batches through the plan forest; F3M / F4M print its sharing report
BATCH_APPS = ("TM", "F3M", "4M", "F4M")
APPS = [*PATTERN_APPS, *BATCH_APPS]
THREE_MOTIF_QUERIES = (TRIANGLE, THREE_CHAIN_INDUCED)
BASELINES = {
    "T": lambda g: baseline.triangle_count(g),
    "TC": lambda g: baseline.three_chain_count(g, induced=True),
    "TT": lambda g: baseline.tailed_triangle_count(g),
    "TM": lambda g: baseline.three_motif(g),
    "4C": lambda g: baseline.clique_count(g, 4),
    "5C": lambda g: baseline.clique_count(g, 5),
}


def run_app(app: str, miner: Miner, fused: bool = True):
    """Serve one app code from the session: an int, or for a motif batch a
    dict of counts by pattern."""
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
                         "per-pattern counts")
    args = ap.parse_args(argv)
    if args.baseline and args.app not in BASELINES:
        ap.error(f"no scalar baseline for {args.app}; "
                 f"have {', '.join(BASELINES)}")

    g = get_dataset(args.dataset, scale=args.scale)
    print(f"[mine] {args.dataset} x{args.scale}: {dataset_stats(g)}")
    miner = Miner(g, MinerConfig(device=args.device))
    if args.app in ("F3M", "F4M"):
        print(f"[mine] forest: {forest_report(args.app, miner)}")
    t0 = time.perf_counter()
    # ints on the host: the device work is done
    res = run_app(args.app, miner, fused=not args.independent)
    dt = time.perf_counter() - t0
    print(f"[mine] {args.app} = {res}  ({dt:.2f}s on {args.device}, "
          f"runner {miner.stats['runner']})")
    if args.check and args.app in ("F3M", "F4M"):
        indep = run_app(args.app, miner, fused=False)
        if indep != res:
            raise SystemExit(f"[mine] fused {res} != independent {indep}")
        print("[mine] fused == independent per-plan counts OK")
    if args.baseline:
        t0 = time.perf_counter()
        rb = run_baseline(args.app, g)
        if rb != res:
            raise SystemExit(f"[mine] baseline {rb} != engine {res}")
        print(f"[mine] baseline(InHouseAutoMine) = {rb} "
              f"({time.perf_counter() - t0:.2f}s)")
    return res


if __name__ == "__main__":
    main()
