"""The benchmark's graphs.

A configuration (``bench/configs/<name>.json``) names its generator under
``generator.kind``: a module ``bench/generators/<kind>.py`` whose
``generate(params, scale)`` returns the edge list and the number of
vertices. The generators belong to the benchmark, not to the program, so
that a change to the program cannot change the graphs it is measured on.
``shuffle`` draws from ``--seed`` the order in which the edge list is
handed over, and each edge's direction: the vertex numbering stays, since
the port breaks a pattern's symmetry by vertex id and another numbering
gives its kernels other work (up to 4% of the card's busy time a pass). A run at full size keeps the generated edge list
under the checkout's ``build/bench/``, keyed by the generator's parameters
and source, and later runs load it.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from pathlib import Path

import numpy as np

GENERATORS = Path(__file__).resolve().parent / "generators"


def edges_of(config: dict, scale: float = 1.0,
             cache_dir: Path | None = None) -> tuple[np.ndarray, int]:
    """(edges, number of vertices) of ``config``'s graph; ``scale`` < 1
    shrinks it (the tests' sizes). With ``cache_dir`` the edge list is read
    from there when an earlier call left it, and left there otherwise."""
    params = config["generator"]
    path = GENERATORS / f"{params['kind']}.py"
    if cache_dir is not None:
        key = hashlib.sha256(json.dumps(params, sort_keys=True).encode() + path.read_bytes()
                             + repr(scale).encode()).hexdigest()[:16]
        kept = Path(cache_dir) / f"{config['name']}-{key}.npz"
        if kept.is_file():
            with np.load(kept) as z:
                return z["edges"].astype(np.int64), int(z["vertices"])
    spec = importlib.util.spec_from_file_location(f"bench_generator_{params['kind']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    edges, num_vertices = mod.generate(params, scale)
    if cache_dir is not None:
        kept.parent.mkdir(parents=True, exist_ok=True)
        part = kept.with_name(f"{kept.name}.{os.getpid()}.part")
        with open(part, "wb") as f:
            np.savez(f, edges=edges.astype(np.int32), vertices=num_vertices)
        os.replace(part, kept)       # whole or not at all, for a run beside this one
    return edges, num_vertices


def shuffle(edges: np.ndarray, seed: int) -> np.ndarray:
    """``edges`` in an order drawn from ``seed`` (any whole number, negative
    or past 64 bits included), each edge's two ends swapped or not by the
    same draw. The vertex ids stay: every seed hands over the same graph,
    numbered alike, so every seed carries the same work."""
    rng = np.random.default_rng(seed % (1 << 64))
    out = edges[rng.permutation(edges.shape[0])]
    flip = rng.random(out.shape[0]) < 0.5
    out[flip] = out[flip][:, ::-1]
    return out
