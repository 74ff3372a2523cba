"""The paper's mining applications (§VI-B) and 4-motif mining, as patterns.

The counterpart of ``repro.mining.apps``. Every function here except the
FSM feed and the host oracle is a **deprecated thin shim** over the
session API: each delegates to a module-level per-graph session
(``shared_session``), so the one-shot surface keeps its behaviour while
the graph moves to the device once and executables are kept across
calls. New code holds a ``Miner`` directly:

    from repro_torch import Miner
    m = Miner(g)
    m.count("triangle"); m.count_many(["diamond", "paw"]) ...

The only hand-written paths left are genuine closed forms (non-induced
three-chain = Σ C(deg, 2)) and the host ``triangle_list_host`` oracle the
device enumeration is held against.

Sessions run on ``cuda`` unless the caller passes ``device="cpu"``, as
every entry point of the port does.
"""
from __future__ import annotations

import warnings
import weakref
from collections import OrderedDict

import numpy as np

from repro_torch.graph.csr import CSRGraph

from .engine import Wave, choose_chunk, compact, expand, half_edges, pair_wave
from .forest import PlanForest
from .plan import (FOUR_MOTIF_SHAPES, TAILED_TRIANGLE, THREE_CHAIN_INDUCED, TRIANGLE,
                   TRIANGLE_NESTED, Pattern, WavePlan, clique_pattern, compile_pattern)
from .session import Miner


def _deprecated(name: str) -> None:
    """One-shot shim warning, emitted per call (importing stays silent:
    the FSM feed lives here)."""
    warnings.warn(
        f"repro_torch.mining.apps.{name} is deprecated; hold a session instead: "
        "repro_torch.Miner(g).count(...)", DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# the module-level session pool backing the deprecated one-shot surface
# ---------------------------------------------------------------------------

# (id(graph), chunk, device_compact, device) -> (weakref to graph, Miner).
# The weakref guards against id() reuse after the original graph is
# collected; a small LRU bounds how many sessions (device copies and
# executable caches) the shim surface keeps alive at once.
_SESSION_POOL: OrderedDict = OrderedDict()
_SESSION_POOL_CAP = 8


def shared_session(g: CSRGraph, chunk: int | None = None, device_compact: bool = True,
                   device: str = "cuda") -> Miner:
    """Get-or-create the module-level ``Miner`` for (graph, config, device):
    every call over the same graph and config lands on one session, so the
    graph's device copy, compiled plans, schedules and executables are
    reused across calls."""
    key = (id(g), chunk, device_compact, str(device))
    ent = _SESSION_POOL.get(key)
    if ent is not None and ent[0]() is g:
        _SESSION_POOL.move_to_end(key)
        return ent[1]
    miner = Miner(g, chunk=chunk, device_compact=device_compact, device=device)
    _SESSION_POOL[key] = (weakref.ref(g), miner)
    while len(_SESSION_POOL) > _SESSION_POOL_CAP:
        _SESSION_POOL.popitem(last=False)
    return miner


def pattern_count(g: CSRGraph, pat: Pattern, chunk: int | None = None,
                  device_compact: bool = True, device: str = "cuda") -> int:
    """Deprecated shim: ``Miner.count`` on the shared session."""
    _deprecated("pattern_count")
    return shared_session(g, chunk, device_compact, device).count(pat)


def pattern_embeddings(g: CSRGraph, pat: Pattern, chunk: int | None = None,
                       device_compact: bool = True, device: str = "cuda") -> np.ndarray:
    """Deprecated shim: ``Miner.embeddings`` on the shared session."""
    _deprecated("pattern_embeddings")
    return shared_session(g, chunk, device_compact, device).embeddings(pat)


def pattern_set_run(g: CSRGraph, plans: list[WavePlan] | PlanForest,
                    chunk: int | None = None, device_compact: bool = True,
                    device: str = "cuda") -> list:
    """Deprecated shim: run a batch of compiled plans (or a built
    ``PlanForest``) as one fused pass on the shared session; results per
    plan, in order (ints for counting plans, (N, k) matrices for emit
    plans)."""
    _deprecated("pattern_set_run")
    miner = shared_session(g, chunk, device_compact, device)
    if isinstance(plans, PlanForest):
        return miner.runner.run_set(plans)
    return miner.run_plans(plans)


def pattern_set_count(g: CSRGraph, pats: list[Pattern], chunk: int | None = None,
                      device_compact: bool = True, device: str = "cuda") -> list[int]:
    """Deprecated shim: ``Miner.count_many`` on the shared session."""
    _deprecated("pattern_set_count")
    return shared_session(g, chunk, device_compact, device).count_many(pats)


def triangle_count(g: CSRGraph, chunk: int | None = None, device_compact: bool = True,
                   device: str = "cuda") -> int:
    """Symmetry-broken triangle counting: one bounded intersection per half
    edge (v0 > v1), bound v1 => each triangle v0 > v1 > v2 counted once."""
    _deprecated("triangle_count")
    return shared_session(g, chunk, device_compact, device).count(TRIANGLE)


def triangle_count_nested(g: CSRGraph, chunk: int | None = None,
                          device: str = "cuda") -> int:
    """Paper-faithful Fig. 4a: one unbounded intersection per directed edge
    counts each triangle 6x; ``TRIANGLE_NESTED.div`` divides it out."""
    _deprecated("triangle_count_nested")
    return shared_session(g, chunk, device=device).count(TRIANGLE_NESTED)


def three_chain_count(g: CSRGraph, induced: bool = False, chunk: int | None = None,
                      device: str = "cuda") -> int:
    """Three-chain (path) counting. Non-induced: Σ_m C(deg m, 2), a closed
    form; induced: the compiled SUB + lower-bound plan."""
    _deprecated("three_chain_count")
    deg = g.degrees.cpu().numpy().astype(np.int64)
    non_induced = int((deg * (deg - 1) // 2).sum())
    if not induced:
        return non_induced
    return shared_session(g, chunk, device=device).count(THREE_CHAIN_INDUCED)


def tailed_triangle_count(g: CSRGraph, chunk: int | None = None,
                          device: str = "cuda") -> int:
    """Fig. 2b dataflow; the tail level folds into the deg(v1) - 2 factor."""
    _deprecated("tailed_triangle_count")
    return shared_session(g, chunk, device=device).count(TAILED_TRIANGLE)


def three_motif(g: CSRGraph, fused: bool = True, device: str = "cuda") -> dict[str, int]:
    """3-motif mining: both connected 3-vertex induced motifs, through one
    session batch (``fused``) or plan by plan."""
    _deprecated("three_motif")
    miner = shared_session(g, device=device)
    if fused:
        t, chains = miner.count_many([TRIANGLE, THREE_CHAIN_INDUCED])
    else:
        t, chains = miner.count(TRIANGLE), miner.count(THREE_CHAIN_INDUCED)
    return {"triangle": t, "chain": chains}


def clique_count(g: CSRGraph, k: int, chunk: int | None = None,
                 device_compact: bool = True, device: str = "cuda") -> int:
    """k-clique counting, k >= 3: the compiled chain-restricted plan."""
    _deprecated("clique_count")
    if k < 3:
        raise ValueError("clique_count needs k >= 3")
    return shared_session(g, chunk, device_compact, device).count(clique_pattern(k))


def four_motif(g: CSRGraph, chunk: int | None = None, fused: bool = True,
               device: str = "cuda") -> dict[str, int]:
    """4-motif mining: induced counts of the six connected 4-vertex motifs,
    through one forest pass (``fused``) or pattern by pattern."""
    _deprecated("four_motif")
    miner = shared_session(g, chunk, device=device)
    if fused:
        counts = miner.count_many(list(FOUR_MOTIF_SHAPES))
        return dict(zip(FOUR_MOTIF_SHAPES, counts))
    from . import plan as P
    return {name: miner.count(P.FOUR_MOTIFS[name]) for name in FOUR_MOTIF_SHAPES}


# the FSM pattern batch: every engine-fed plan FSM's support evaluation
# consumes, merged into one forest (a single feed pass). Today that is the
# triangle emit plan — wedge/star/path domains are closed forms over the
# neighbour-label count table.
FSM_FEED_PLANS: tuple = (compile_pattern(TRIANGLE, emit=True),)


def fsm_pattern_feed(g: CSRGraph, chunk: int | None = None, miner: Miner | None = None,
                     device: str = "cuda") -> list:
    """Run the FSM engine-feed batch on a session; returns per-plan results
    in ``FSM_FEED_PLANS`` order (triangle embeddings first). ``miner``
    reuses a caller-held session (FSM passes its own)."""
    miner = miner or shared_session(g, chunk, device=device)
    return miner.run_plans(list(FSM_FEED_PLANS))


def triangle_list(g: CSRGraph, chunk: int | None = None, device: str = "cuda") -> np.ndarray:
    """All triangles as (T, 3) vertex triples (v0 > v1 > v2), from the
    triangle emit plan on the shared session: compacted on the device, only
    the embedding rows cross to the host."""
    _deprecated("triangle_list")
    return fsm_pattern_feed(g, chunk, device=device)[0]


def triangle_list_host(g: CSRGraph, chunk: int | None = None) -> np.ndarray:
    """Host-compaction oracle for ``triangle_list`` (``expand`` +
    ``compact(return_src=True)`` over the pair feed), on the device of
    ``g``'s tensors: the reference the device emit path is held against."""
    chunk = chunk or choose_chunk(g.padded_max_degree)
    out = []
    for rows0, _rows1, v0, v1, n in pair_wave(g, half_edges(g), chunk):
        rows2, counts2 = expand(g, Wave(rows=rows0, verts=v1))
        w2, ii = compact(rows2, counts2, limit=n, return_src=True)
        if w2 is None:
            continue
        out.append(np.stack([v0[ii], v1[ii], w2.verts], axis=1))
    if not out:
        return np.zeros((0, 3), dtype=np.int32)
    return np.concatenate(out, axis=0).astype(np.int32)
