"""Scenario, on the PyTorch/CUDA port: mine all seven paper applications
over a paper-twin dataset, comparing the stream engine against both
baselines, plus FSM with the correct (MNI) vs GRAMER's broken (count)
support.

  PYTHONPATH=src python examples/mine_patterns_torch.py               # on the card
  PYTHONPATH=src python examples/mine_patterns_torch.py --device cpu  # plain torch versions

The counterpart of ``examples/mine_patterns.py`` through ``repro_torch``
alone: it prints the same lines, and every count in them is the JAX
example's.
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import time

from repro_torch.graph import get_dataset
from repro_torch.graph.datasets import dataset_stats
from repro_torch.mining import Miner, baseline, exhaustive
from repro_torch.mining.fsm import fsm, random_labels, sfsm
from repro_torch.mining.plan import clique_pattern

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the hand kernels) or cpu (their plain torch versions)")
dev = ap.parse_args().device

g = get_dataset("email-eu-core")
print("[mine] email-eu-core twin:", dataset_stats(g))

# one resident session serves every query: the graph is staged to the
# device once and executables are cached across apps
m = Miner(g, device=dev)


def three_motif():
    t, chain = m.count_many(["triangle", "three-chain"])
    return {"triangle": t, "chain": chain}


for name, eng, base in [
    ("triangle", lambda: m.count("triangle"),
     lambda: baseline.triangle_count(g)),
    ("3-chain(ind)", lambda: m.count("three-chain"),
     lambda: baseline.three_chain_count(g, induced=True)),
    ("tailed-tri", lambda: m.count("tailed-triangle"),
     lambda: baseline.tailed_triangle_count(g)),
    ("3-motif", three_motif, lambda: baseline.three_motif(g)),
    ("4-clique", lambda: m.count(clique_pattern(4)),
     lambda: baseline.clique_count(g, 4)),
    ("5-clique", lambda: m.count(clique_pattern(5)),
     lambda: baseline.clique_count(g, 5)),
]:
    t0 = time.time()
    r = eng()
    t1 = time.time() - t0
    t0 = time.time()
    rb = base()
    t2 = time.time() - t0
    if r != rb:
        raise SystemExit(f"[mine] {name}: engine {r} != scalar baseline {rb}")
    print(f"[mine] {name:12s} = {r!s:>14}  engine {t1:6.2f}s | scalar {t2:6.2f}s")

t0 = time.time()
ex = exhaustive.exhaustive_count(g, "triangle")
print(f"[mine] GRAMER-style exhaustive triangle = {ex} "
      f"({time.time()-t0:.2f}s — the method the paper shows losing)")

labels = random_labels(g.num_vertices, 4, seed=7)
t0 = time.time()
freq = fsm(g, labels, min_support=400, device=dev)
print(f"[mine] FSM (MNI support>=400): {len(freq)} frequent patterns "
      f"({time.time()-t0:.1f}s)")
wrong = sfsm(g, labels, min_support=400, device=dev)
print(f"[mine] sFSM (GRAMER count-support): {len(wrong)} patterns — "
      "violates downward closure (§VI-B)")
