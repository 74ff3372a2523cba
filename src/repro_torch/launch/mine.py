"""Graph mining launcher — one ``Miner`` session serving one app.

  python -m repro_torch.launch.mine --app T --dataset mico
  python -m repro_torch.launch.mine --app 4C --dataset email-eu-core \\
      --scale 0.25 --device cpu --baseline

Runs on the CUDA device unless ``--device cpu``. ``--baseline`` checks the
count against the scalar InHouseAutoMine enumeration (T, TC, TT, 4C, 5C;
keep it off 5C on large graphs: it is exponential).

Apps are single patterns. The JAX launcher's motif batches, TM (the
3-motifs) and 4M (the six 4-motifs), run their patterns through one plan
forest (``Miner.count_many``), which this package does not have yet; here
their patterns run one by one: T and TC for TM; DM, CY, PW, P4, S4 and 4C
for 4M.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.graph.datasets import DATASETS, dataset_stats, get_dataset
from repro_torch.mining import baseline
from repro_torch.mining.session import Miner, MinerConfig

from .cli import add_graph_args

APPS = {"T": "triangle", "TS": "triangle-nested", "TC": "three-chain",
        "TT": "tailed-triangle", "4C": "4-clique", "5C": "5-clique",
        "DM": "diamond", "CY": "4-cycle", "PW": "paw", "P4": "4-path",
        "S4": "4-star"}
BASELINES = {
    "T": lambda g: baseline.triangle_count(g),
    "TC": lambda g: baseline.three_chain_count(g, induced=True),
    "TT": lambda g: baseline.tailed_triangle_count(g),
    "4C": lambda g: baseline.clique_count(g, 4),
    "5C": lambda g: baseline.clique_count(g, 5),
}


def run_app(app: str, miner: Miner) -> int:
    """Serve one app code from the session."""
    return miner.count(APPS[app])


def run_baseline(app: str, g) -> int:
    return BASELINES[app](g)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", choices=list(APPS), default="T",
                    help="one pattern; TM and 4M (plan-forest batches) "
                         "arrive with Miner.count_many")
    add_graph_args(ap, choices=list(DATASETS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to mine on (cuda, or cpu for the "
                         "kernels' plain torch versions)")
    ap.add_argument("--baseline", action="store_true",
                    help="also run InHouseAutoMine (scalar CPU) and compare "
                         f"({', '.join(BASELINES)})")
    args = ap.parse_args(argv)
    if args.baseline and args.app not in BASELINES:
        ap.error(f"no scalar baseline for {args.app}; "
                 f"have {', '.join(BASELINES)}")

    g = get_dataset(args.dataset, scale=args.scale)
    print(f"[mine] {args.dataset} x{args.scale}: {dataset_stats(g)}")
    miner = Miner(g, MinerConfig(device=args.device))
    t0 = time.perf_counter()
    res = run_app(args.app, miner)     # an int: the device work is done
    dt = time.perf_counter() - t0
    print(f"[mine] {args.app} = {res}  ({dt:.2f}s on {args.device}, "
          f"runner {miner.stats['runner']})")
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
