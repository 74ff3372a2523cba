#!/usr/bin/env python3
"""The control of the benchmark's comparison: a session that breaks the
configurations' guarantee of exact counts, put in the program's place.

    python3 bench/control.py --workload mico.cliques --seeds 101 102 103

``ControlSession`` answers every query with the plain reference's estimate
from an edge sample: each edge of the graph kept with probability
``KEEP`` (drawn from the run's seed), the sampled graph's count scaled by
``KEEP ** -edges`` of the pattern, rounded (the sampling estimators of
approximate mining). The command runs the harness on the card with it in
the program's place, a short window at the cell's own size, and prints each
seed's compared numbers; the comparison must find it not correct. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KEEP = 0.99


class ControlSession:
    """Answers ``count`` and ``count_many`` with sampled estimates."""

    def __init__(self, edges, num_vertices: int, seed: int, device="cpu"):
        from bench import reference
        e = np.asarray(edges, dtype=np.int64)
        lo, hi = e.min(axis=1), e.max(axis=1)
        key = np.unique((lo * num_vertices + hi)[lo != hi])
        rng = np.random.default_rng(seed % (1 << 64))
        kept = key[rng.random(key.shape[0]) < KEEP]
        pairs = np.stack([kept // num_vertices, kept % num_vertices], 1)
        sampled = reference.counts(pairs, num_vertices, device=device)
        self.estimate = {q: int(round(n / KEEP ** reference.PATTERN_EDGES[q]))
                         for q, n in sampled.items()}

    def count(self, query):
        return self.estimate[query]

    def count_many(self, queries):
        return [self.estimate[q] for q in queries]


def factory(seed: int, device: str):
    """``run_cell``'s ``make_session`` for the control at ``seed``."""
    return lambda graph, edges, num_vertices: ControlSession(edges, num_vertices, seed,
                                                             device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench import run
    if not torch.cuda.is_available():
        print("the control runs on a card; torch sees none", file=sys.stderr)
        return 2
    spec = run.load_spec(ROOT)
    ok = True
    for seed in args.seeds:
        r = run.run_cell(spec, args.workload, seed, args.seconds, False,
                         make_session=factory(seed, "cuda"), t_start=time.perf_counter())
        print(json.dumps({"control": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "compared": r["compared"]}), flush=True)
        ok = ok and not r["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
