"""Worker pool: one ``Miner`` session per traffic class.

A ``WorkerSpec`` binds a traffic-class name to a full ``MinerConfig`` —
the service can therefore mix an unsharded ``Miner(g)`` for latency
traffic with a mesh-sharded ``Miner(g, mesh=S)`` for heavy batches
(``WorkerSpec("bulk", MinerConfig(mesh=8))``); their executable caches
are topology-keyed (see the ``mining.session`` cache-key doc) and never
collide.

Each worker keeps its OWN ``Telemetry`` (built by ``Miner`` from its
config): the per-session registries back each session's legacy ``stats``
view, and sharing one registry across sessions would alias their
counters. The service aggregates across workers through ``retraces()`` /
``stats()`` instead.

``set_graph`` rebuilds every session against the new graph — sessions
are graph-resident by design, so a swap pays the staging + warm-up cost
again (the service bumps its cache version at the same time).
"""
from __future__ import annotations

import dataclasses

from repro_torch.graph.csr import CSRGraph
from repro_torch.mining.session import Miner, MinerConfig

__all__ = ["WorkerPool", "WorkerSpec"]

DEFAULT_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One traffic class -> one session configuration."""

    traffic_class: str = DEFAULT_CLASS
    config: MinerConfig = dataclasses.field(default_factory=MinerConfig)


class WorkerPool:
    """Traffic-class-keyed ``Miner`` sessions over one shared graph."""

    def __init__(self, graph: CSRGraph, specs=(WorkerSpec(),)):
        specs = tuple(specs)
        if not specs:
            raise ValueError("WorkerPool needs at least one WorkerSpec")
        seen = [s.traffic_class for s in specs]
        if len(set(seen)) != len(seen):
            raise ValueError(f"duplicate traffic classes: {seen}")
        self.specs = specs
        # unknown classes fall back to the first spec's session
        self._fallback = specs[0].traffic_class
        self._workers: dict[str, Miner] = {}
        self._build(graph)

    def _build(self, graph: CSRGraph) -> None:
        self.graph = graph
        self._workers = {s.traffic_class: Miner(graph, s.config)
                         for s in self.specs}

    # ------------------------------------------------------------- access
    @property
    def classes(self) -> tuple[str, ...]:
        return tuple(self._workers)

    def worker(self, traffic_class: str = DEFAULT_CLASS) -> Miner:
        w = self._workers.get(traffic_class)
        return w if w is not None else self._workers[self._fallback]

    def set_graph(self, graph: CSRGraph) -> None:
        """Swap every session onto a new graph (staging + warm-up redo)."""
        self._build(graph)

    # -------------------------------------------------------------- stats
    def retraces(self) -> int:
        """Executables built across the pool — the steady-state-0 gate."""
        return sum(w.exec_cache.misses for w in self._workers.values())

    def stats(self) -> dict:
        return {tc: {"queries": w.stats["queries"],
                     "retraces": w.exec_cache.misses,
                     "exec_entries": len(w.exec_cache),
                     "mesh": None if w.mesh is None
                     else dict(w.mesh.shape)}
                for tc, w in self._workers.items()}
