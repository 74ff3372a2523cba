"""The port's example counterparts (``examples/*_torch.py``) against the JAX
examples, on the CPU: each pair runs side by side in subprocesses, and every
printed line equals the JAX example's with its timings blanked (the counts,
shapes, aggregates and sharing figures line for line)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "mine_patterns"]
# a timing, with the padding before it, whose width the timing sets
TIMING = re.compile(r" *\d+\.\d+m?s\b")
# the one line whose content is timings alone: its keys are the three
# slowest spans, an order that timings decide
TIMED_ONLY = ("hottest spans",)


def _lines(text: str) -> list[str]:
    return [TIMING.sub(" <t>", ln) for ln in text.splitlines()
            if ln.strip() and not ln.startswith(TIMED_ONLY)]


@pytest.fixture(scope="module")
def runs():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for name in EXAMPLES:
        for side, script, args in (("jax", f"{name}.py", []),
                                   ("port", f"{name}_torch.py", ["--device", "cpu"])):
            procs[name, side] = subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / script), *args], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=400)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            p.kill()
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_jax_examples_counts(runs, name):
    (jrc, jout, jerr), (rc, out, err) = runs[name, "jax"], runs[name, "port"]
    assert jrc == 0, jerr[-2000:]
    assert rc == 0, err[-2000:]
    assert _lines(out) == _lines(jout)
    assert len(_lines(out)) >= 9


def test_quickstart_counts(runs):
    """The numbers both quickstarts print, written down (erdos_renyi(500,
    3000, seed=0); edge weights of seed 1)."""
    want = ["triangles          : 322", "3-chains (induced) : 38193",
            "tailed triangles   : 13027",
            "4-motifs (fused)   : {'4-clique': 0, 'diamond': 167, '4-cycle': 3148, "
            "'paw': 12359, '4-path': 453458, '4-star': 169714}",
            "weighted triangles : 79.765625", "request results    : [322, 12359] [322, 3148]",
            "retraces on repeat : 0"]
    for side in ("jax", "port"):
        lines = runs["quickstart", side][1].splitlines()
        assert all(w in lines for w in want), (side, lines)
