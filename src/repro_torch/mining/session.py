"""Miner session API: a graph-resident query engine.

    m = Miner(graph)                   # graph moves to the card once
    m.count("triangle")                # -> int
    m.count_many(["4-clique", "diamond", "4-cycle",
                  "paw", "4-path", "4-star"])   # -> list[int], one pass
    m.aggregate("triangle", "sum")     # -> float, on a weighted graph

The counterpart of ``repro.mining.session``. Every query runs through
three stages, each memoised for the session's lifetime:

**compile** — a query (a name from ``plan._NAMED_QUERIES``, a ``Motif``
shape, or an explicit ``Pattern``) lowers to a ``WavePlan`` via
``plan.compile_pattern``; a ``Motif`` first gets its matching order from
``forest.schedule_patterns``. Plans are cached per (query, aggregate op).

**schedule** — for a batch (``count_many``, ``aggregate_many``), the
matching-order search (``forest.schedule_patterns``) picks each ``Motif``'s
order to share the most prefix across the batch, and ``forest.build_forest``
merges the plans into a ``PlanForest``; forests are cached per batch.

**execute** — ``engine.WaveRunner`` interprets the plan or the forest. The
graph's CSR tensors move to the session's device once, at construction,
and every built level executable lives in the session's
``ExecutableCache`` (keys: ``(chunk, device_compact, fused_level, kind,
LevelOp, capacity signature, ...)``), so a repeated query rebuilds nothing
(``stats['rebuilds']`` counts the misses). ``device_compact=False`` takes
the host-compaction path (``engine`` module docstring).

**Value streams** — on a weighted graph (``graph.with_edge_values`` or
``build_csr(..., edge_values=)``) ``aggregate(query, op)`` reduces the
embeddings' values with ``op`` ('sum' / 'max' / 'min'): an embedding's
value is the product of its pattern edges' weights. A weighted plan runs
its unweighted twin's levels and feed chunks (a count plan may fold its
last level into a degree factor, which a weighted plan cannot); its leaf
carries the value lane (``engine.WaveRunner._agg_body``).

A session runs on ``cuda`` unless its config says ``device="cpu"``; with
no card it raises rather than carrying on on the CPU. A ``Miner`` is
single-threaded.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import LegacyStatsView, Telemetry

from .engine import WaveRunner
from .forest import PlanForest, build_forest, schedule_patterns
from .plan import Motif, WavePlan, compile_pattern, resolve_query

__all__ = ["ExecutableCache", "Miner", "MinerConfig"]


class ExecutableCache:
    """Session-lifetime cache of built level executables, with hit/miss
    stats; ``misses`` counts executables actually built — the session's
    *rebuild* counter."""

    def __init__(self):
        self._entries: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: tuple, build: Callable):
        """Return (executable, freshly_built?) for ``key``."""
        fn = self._entries.get(key)
        if fn is None:
            fn = self._entries[key] = build()
            self.misses += 1
            return fn, True
        self.hits += 1
        return fn, False

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


@dataclasses.dataclass(frozen=True)
class MinerConfig:
    """Session construction knobs (``Miner(g, **kwargs)`` builds one)."""

    chunk: int | None = None          # wave chunk; None = auto-sized
    device: str = "cuda"              # "cpu" runs the kernels' plain versions
    fused_level: bool = True          # general levels: one k-reference launch
    device_compact: bool = True       # False: the host compaction path


class Miner:
    """A graph-resident mining session: compile → schedule → execute."""

    # session counters, in the reference session's order
    _SESSION_KEYS = ("queries", "plan_hits", "plan_misses",
                     "schedule_hits", "schedule_misses")

    def __init__(self, graph: CSRGraph, config: MinerConfig | None = None,
                 **overrides):
        if config is None:
            config = MinerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        device = torch.device(config.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Miner runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "mine with the kernels' plain torch versions")
        self.config = config
        self.telemetry = Telemetry()
        self.metrics = self.telemetry.metrics
        # the CSR tensors move to the device once per session; queries only
        # ship per-chunk vertex ids after this
        self.graph = graph.to(device)
        self.exec_cache = ExecutableCache()
        self._runner = WaveRunner(self.graph, self.exec_cache, chunk=config.chunk,
                                  telemetry=self.telemetry,
                                  fused_level=config.fused_level,
                                  device_compact=config.device_compact)
        self._plans: dict = {}
        self._forests: dict[tuple, PlanForest] = {}
        self._stats = LegacyStatsView()
        self._sct = {k: self._stats.expose_counter(k, self.metrics)
                     for k in self._SESSION_KEYS}

    def compile(self, query, aggregate: str | None = None) -> WavePlan:
        """Lower one query to a ``WavePlan`` (cached); ``aggregate`` compiles
        the weighted (SVPU value) program."""
        resolved = resolve_query(query)
        key = (resolved, False, aggregate)     # (query, emit, aggregate)
        plan = self._plans.get(key)
        if plan is not None:
            self._sct["plan_hits"].inc()
            return plan
        self._sct["plan_misses"].inc()
        pat = schedule_patterns([resolved])[0] if isinstance(resolved, Motif) \
            else resolved
        plan = self._plans[key] = compile_pattern(pat, aggregate=aggregate)
        return plan

    def schedule(self, queries: Sequence, aggregate: str | None = None) -> PlanForest:
        """Lower a batch to one ``PlanForest`` (cached per batch): ``Motif``
        members get their matching orders from the joint shared-prefix
        search, with explicit ``Pattern`` members as fixed points, and the
        compiled plans merge into one prefix trie."""
        resolved = tuple(resolve_query(q) for q in queries)
        key = (resolved, False, aggregate)     # (batch, emit, aggregate)
        forest = self._forests.get(key)
        if forest is not None:
            self._sct["schedule_hits"].inc()
            return forest
        self._sct["schedule_misses"].inc()
        plans = []
        for r, p in zip(resolved, schedule_patterns(resolved)):
            plan = compile_pattern(p, aggregate=aggregate)
            self._plans.setdefault((r, False, aggregate), plan)
            plans.append(plan)
        forest = self._forests[key] = build_forest(plans)
        return forest

    def count(self, query) -> int:
        """Count embeddings of one pattern query."""
        self._sct["queries"].inc()
        return self._runner.run(self.compile(query))

    def count_many(self, queries: Sequence) -> list[int]:
        """Count a batch of queries in one fused forest pass; results are
        positional and equal to per-query ``count`` calls on the same
        scheduled patterns."""
        self._sct["queries"].inc()
        return self._runner.run_set(self.schedule(queries))

    def _require_values(self) -> None:
        if self.graph.edge_values is None:
            raise ValueError(
                "aggregate queries need a weighted graph — build with "
                "edge_values (graph.build_csr(..., edge_values=...) or "
                "graph.with_edge_values)")

    def aggregate(self, query, op: str = "sum") -> float:
        """Reduce the embedding values of one query with ``op`` ('sum' /
        'max' / 'min'); an embedding's value is the product of its
        pattern-edge weights (0.0 when the query has no embedding)."""
        self._require_values()
        self._sct["queries"].inc()
        return self._runner.run(self.compile(query, aggregate=op))

    def aggregate_many(self, queries: Sequence, op: str = "sum") -> list[float]:
        """Aggregate a batch of queries in one fused forest pass: the
        aggregate leaves share the forest's expands as ``count_many``'s
        leaves do."""
        self._require_values()
        self._sct["queries"].inc()
        return self._runner.run_set(self.schedule(queries, aggregate=op))

    def run_plans(self, plans: Sequence[WavePlan]) -> list:
        """Execute compiled plans: one runs directly, several fuse through a
        forest cached on their canonical keys."""
        self._sct["queries"].inc()
        plans = list(plans)
        if len(plans) == 1:
            return [self._runner.run(plans[0])]
        key = ("plans", tuple(p.canonical_key() for p in plans))
        forest = self._forests.get(key)
        if forest is None:
            self._sct["schedule_misses"].inc()
            forest = self._forests[key] = build_forest(plans)
        else:
            self._sct["schedule_hits"].inc()
        return self._runner.run_set(forest)

    @property
    def runner(self) -> WaveRunner:
        """The session's execute-stage interpreter."""
        return self._runner

    @property
    def stats(self) -> dict:
        """Session counters, the executable cache (``rebuilds`` = misses)
        and the runner's dispatch/sync counters."""
        cache = self.exec_cache.snapshot()
        return {**self._stats, "exec_cache": cache,
                "rebuilds": self.exec_cache.misses,
                "runner": dict(self._runner.stats)}
