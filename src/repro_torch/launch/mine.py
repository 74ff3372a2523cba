"""Graph mining launcher — one ``Miner`` session serving one app.

  python -m repro_torch.launch.mine --app T --dataset mico
  python -m repro_torch.launch.mine --app 4C --dataset email-eu-core \\
      --scale 0.25 --device cpu --baseline

Runs on the CUDA device unless ``--device cpu``. ``--baseline`` checks the
count against the scalar InHouseAutoMine enumeration (keep it off 5C on
large graphs: it is exponential).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.graph.datasets import DATASETS, dataset_stats, get_dataset
from repro_torch.mining import baseline
from repro_torch.mining.session import Miner, MinerConfig

from .cli import add_graph_args

APPS = {"T": "triangle", "4C": "4-clique", "5C": "5-clique"}


def run_app(app: str, miner: Miner) -> int:
    """Serve one app code from the session."""
    return miner.count(APPS[app])


def run_baseline(app: str, g) -> int:
    return baseline.clique_count(g, {"T": 3, "4C": 4, "5C": 5}[app])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", choices=list(APPS), default="T")
    add_graph_args(ap, choices=list(DATASETS))
    ap.add_argument("--device", default="cuda",
                    help="torch device to mine on (cuda, or cpu for the "
                         "kernels' plain torch versions)")
    ap.add_argument("--baseline", action="store_true",
                    help="also run InHouseAutoMine (scalar CPU) and compare")
    args = ap.parse_args(argv)

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
