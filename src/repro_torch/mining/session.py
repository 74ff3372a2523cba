"""Miner session API: a graph-resident query engine.

    m = Miner(graph)                   # graph moves to the card once
    m.count("triangle")                # -> int
    m.count_many(["4-clique", "diamond", "4-cycle",
                  "paw", "4-path", "4-star"])   # -> list[int], one pass
    m.aggregate("triangle", "sum")     # -> float, on a weighted graph
    m.embeddings("triangle")           # -> (N, 3) int32 matrix on the host

The counterpart of ``repro.mining.session``. Every query runs through
three stages, each memoised for the session's lifetime:

**compile** — a query (a name from ``plan._NAMED_QUERIES``, a ``Motif``
shape, or an explicit ``Pattern``) lowers to a ``WavePlan`` via
``plan.compile_pattern``; a ``Motif`` first gets its matching order from
``forest.schedule_patterns``. Plans are cached per (query, emit, aggregate
op): ``emit=True`` compiles the plan whose last level emits embeddings.

**schedule** — for a batch (``count_many``, ``aggregate_many``), the
matching-order search (``forest.schedule_patterns``) picks each ``Motif``'s
order to share the most prefix across the batch, and ``forest.build_forest``
merges the plans into a ``PlanForest``; forests are cached per batch.

**execute** — ``engine.WaveRunner`` interprets the plan or the forest. The
graph's CSR tensors move to the session's device once, at construction,
and every built level executable lives in the session's
``ExecutableCache`` (keys: ``(mesh_signature, chunk, device_compact,
fused_level, kind, LevelOp, capacity signature, ...)``), so a repeated query rebuilds nothing
(``stats['rebuilds']`` counts the misses). ``device_compact=False`` takes
the host-compaction path (``engine`` module docstring).

**Value streams** — on a weighted graph (``graph.with_edge_values`` or
``build_csr(..., edge_values=)``) ``aggregate(query, op)`` reduces the
embeddings' values with ``op`` ('sum' / 'max' / 'min'): an embedding's
value is the product of its pattern edges' weights. A weighted plan runs
its unweighted twin's levels and feed chunks (a count plan may fold its
last level into a degree factor, which a weighted plan cannot); its leaf
carries the value lane (``engine.WaveRunner._agg_body``).

**Observability** — every session carries a ``repro_torch.obs.Telemetry``
(``miner.telemetry``): its metrics registry backs every counter of
``miner.stats``, and its tracer, off unless the session is built with
``telemetry=Telemetry(enabled=True)`` (or ``MinerConfig.from_args`` of a
launcher's ``--trace``), records a span tree per query: ``query`` →
``compile``/``schedule``/``execute`` → ``feed`` and ``L{l}:{kind}`` level
spans → ``dispatch`` spans around each level call, ended by a synchronize
on a card. ``telemetry.write_trace(path)`` writes it as Chrome-trace JSON.
The tracer is no part of any cache key, and with it off the engine opens
no span and adds no synchronize and no launch.
``with miner.telemetry.torch_profile(logdir, miner.config.device): ...``
wraps a query in ``torch.profiler`` (its kernels' device events on a card)
and writes the profile's Chrome trace to ``logdir`` (the JAX package's
``jax_profile`` hook; the launchers' ``--torch-profile``).

**Mesh** — ``Miner(g, mesh=S)`` (S > 1) mines data-parallel over S
shards (``mining.shard.ShardedWaveRunner``): the first S cards of a
``cuda`` session, S times the CPU for ``device="cpu"``, or the devices
``mesh_devices`` lists, which may repeat a card (``("cuda:0",) * 8``:
eight shards on one card). A mesh that wants more cards than are visible
raises. The executable cache's keys start with ``mesh_signature(mesh)``,
and the sharded runner's with ``("mesh", axis, S)``, so sharded and
unsharded executables never collide. Counts are bit-identical to the
unsharded session's; ``stats["runner"]`` adds ``psum_reductions`` and
``shard_feed_items``.

A session runs on ``cuda`` unless its config says ``device="cpu"``; with
no card it raises rather than carrying on on the CPU. A ``Miner`` is
single-threaded.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import make_mining_mesh
from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import LegacyStatsView, Telemetry

from .engine import WaveRunner
from .forest import PlanForest, build_forest, schedule_patterns
from .plan import Motif, WavePlan, compile_pattern, resolve_query
from .shard import ShardedWaveRunner

__all__ = ["ExecutableCache", "Miner", "MinerConfig", "mesh_signature"]


def mesh_signature(mesh=None, device="cuda") -> tuple:
    """The device part of every executable-cache key. Unsharded: the type of
    the session's ``device`` and its count (the visible cards for ``cuda``,
    1 for the CPU). Sharded: the type and number of the mesh's distinct
    devices, then its axes ``((name, size),)``. Meshes of other axes or
    sizes never share an executable, and the unsharded signature never
    equals a sharded one."""
    if mesh is None:
        kind = torch.device(device).type
        return (kind, torch.cuda.device_count() if kind == "cuda" else 1)
    return (mesh.devices[0].type, len(set(mesh.devices))) + \
        tuple((str(a), int(s)) for a, s in dict(mesh.shape).items())


class ExecutableCache:
    """Session-lifetime cache of built level executables, with hit/miss
    stats; ``misses`` counts executables actually built — the session's
    *rebuild* counter. Every key starts with ``prefix`` and the
    ``mesh_signature`` of the mesh, or of ``device`` when there is none."""

    def __init__(self, prefix: tuple = (), mesh=None, device="cuda"):
        self.prefix = prefix + (mesh_signature(mesh, device),)
        self._entries: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: tuple, build: Callable):
        """Return (executable, freshly_built?) for ``key``."""
        key = self.prefix + key
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
    """Session construction knobs (``Miner(g, **kwargs)`` builds one).
    ``telemetry`` is observability wiring, not an execution knob: it takes
    no part in equality or in any cache key."""

    chunk: int | None = None          # wave chunk; None = auto-sized
    device: str = "cuda"              # "cpu" runs the kernels' plain versions
    fused_level: bool = True          # general levels: one k-reference launch
    device_compact: bool = True       # False: the host compaction path
    mesh: int | None = None           # >1: shard over that many devices
    mesh_axis: str = "mine"           # mesh axis name (cache-key relevant)
    feed_partition: str = "round_robin"  # edge-feed dealing (shard.py)
    # the mesh's devices, one a shard (may repeat a card); None: the first
    # ``mesh`` cards, or ``mesh`` times the CPU for device="cpu"
    mesh_devices: tuple[str, ...] | None = None
    # the session's Telemetry; None = a fresh one with tracing off
    telemetry: Telemetry | None = dataclasses.field(default=None, compare=False,
                                                    repr=False)

    @classmethod
    def from_args(cls, args, **overrides) -> "MinerConfig":
        """A config from a parsed launcher namespace (``launch.cli`` flag
        names): ``--chunk`` -> ``chunk``, ``--trace OUT`` -> a Telemetry with
        tracing on, ``--device`` -> ``device``, ``--shards N`` -> ``mesh``
        (N > 1). Missing attributes take the field defaults; ``overrides``
        win over flags."""
        shards = int(getattr(args, "shards", 0) or 0)
        cfg = cls(chunk=getattr(args, "chunk", None),
                  device=getattr(args, "device", None) or "cuda",
                  mesh=shards if shards > 1 else None,
                  telemetry=Telemetry(enabled=bool(getattr(args, "trace", ""))))
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


class Miner:
    """A graph-resident mining session: compile → schedule → execute."""

    # session counters, in the reference session's order
    _SESSION_KEYS = ("queries", "plan_hits", "plan_misses",
                     "schedule_hits", "schedule_misses")

    def __init__(self, graph: CSRGraph, config: MinerConfig | None = None,
                 telemetry: Telemetry | None = None, **overrides):
        if telemetry is not None:
            overrides["telemetry"] = telemetry
        if config is None:
            config = MinerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        device = torch.device(config.device)
        sharded = config.mesh is not None and int(config.mesh) > 1
        if sharded and {torch.device(d).type for d in config.mesh_devices or ()} - {device.type}:
            raise ValueError(f"mesh_devices {config.mesh_devices} are not all of the "
                             f"session's device type {device.type!r}")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Miner runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "mine with the kernels' plain torch versions")
        self.config = config
        # one Telemetry for the session and its runner: every counter lands
        # in one registry, every span of a traced query in one tracer
        self.telemetry = config.telemetry if config.telemetry is not None else Telemetry()
        self.metrics = self.telemetry.metrics
        if sharded:
            self.mesh = make_mining_mesh(int(config.mesh), axis=config.mesh_axis,
                                         devices=config.mesh_devices,
                                         device_type=device.type)
            self.exec_cache = ExecutableCache(mesh=self.mesh)
            self._runner = ShardedWaveRunner(
                graph, self.mesh, self.exec_cache, axis=config.mesh_axis,
                feed_partition=config.feed_partition, chunk=config.chunk,
                device_compact=config.device_compact, fused_level=config.fused_level,
                telemetry=self.telemetry)
            # shard 0's copy of the CSR, which the runner put on each device
            self.graph = self._runner.g[0]
        else:
            # the CSR tensors move to the device once per session; queries
            # only ship per-chunk vertex ids after this
            self.mesh = None
            self.graph = graph.to(device)
            self.exec_cache = ExecutableCache(device=device)
            self._runner = WaveRunner(self.graph, self.exec_cache, chunk=config.chunk,
                                      telemetry=self.telemetry,
                                      fused_level=config.fused_level,
                                      device_compact=config.device_compact)
        self._plans: dict = {}
        self._forests: dict[tuple, PlanForest] = {}
        self._stats = LegacyStatsView()
        self._sct = {k: self._stats.expose_counter(k, self.metrics)
                     for k in self._SESSION_KEYS}

    def _span(self, name: str, **attrs):
        """A span of the session's tracer; a no-op context with tracing off."""
        tr = self.telemetry.tracer
        return tr.span(name, **attrs) if tr.enabled else nullcontext()

    def compile(self, query, emit: bool = False,
                aggregate: str | None = None) -> WavePlan:
        """Lower one query to a ``WavePlan`` (cached); ``emit`` compiles the
        plan whose last level emits embeddings, ``aggregate`` the weighted
        (SVPU value) program."""
        with self._span("compile", query=str(query), emit=emit):
            resolved = resolve_query(query)
            key = (resolved, emit, aggregate)
            plan = self._plans.get(key)
            if plan is not None:
                self._sct["plan_hits"].inc()
                return plan
            self._sct["plan_misses"].inc()
            pat = schedule_patterns([resolved])[0] if isinstance(resolved, Motif) \
                else resolved
            plan = self._plans[key] = compile_pattern(pat, emit=emit, aggregate=aggregate)
            return plan

    def schedule(self, queries: Sequence, emit: bool = False,
                 aggregate: str | None = None) -> PlanForest:
        """Lower a batch to one ``PlanForest`` (cached per batch): ``Motif``
        members get their matching orders from the joint shared-prefix
        search, with explicit ``Pattern`` members as fixed points, and the
        compiled plans merge into one prefix trie."""
        with self._span("schedule", queries=len(queries), emit=emit):
            resolved = tuple(resolve_query(q) for q in queries)
            key = (resolved, emit, aggregate)
            forest = self._forests.get(key)
            if forest is not None:
                self._sct["schedule_hits"].inc()
                return forest
            self._sct["schedule_misses"].inc()
            plans = []
            for r, p in zip(resolved, schedule_patterns(resolved)):
                plan = compile_pattern(p, emit=emit, aggregate=aggregate)
                self._plans.setdefault((r, emit, aggregate), plan)
                plans.append(plan)
            forest = self._forests[key] = build_forest(plans)
            return forest

    def _query_span(self, kind: str, **attrs):
        """The root span of one traced query."""
        return self._span("query", kind=kind, **attrs)

    def count(self, query) -> int:
        """Count embeddings of one pattern query."""
        self._sct["queries"].inc()
        with self._query_span("count", query=str(query)):
            return self._runner.run(self.compile(query))

    def count_many(self, queries: Sequence) -> list[int]:
        """Count a batch of queries in one fused forest pass; results are
        positional and equal to per-query ``count`` calls on the same
        scheduled patterns."""
        self._sct["queries"].inc()
        with self._query_span("count_many", queries=len(queries)):
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
        with self._query_span("aggregate", query=str(query), op=op):
            return self._runner.run(self.compile(query, aggregate=op))

    def aggregate_many(self, queries: Sequence, op: str = "sum") -> list[float]:
        """Aggregate a batch of queries in one fused forest pass: the
        aggregate leaves share the forest's expands as ``count_many``'s
        leaves do."""
        self._require_values()
        self._sct["queries"].inc()
        with self._query_span("aggregate_many", queries=len(queries), op=op):
            return self._runner.run_set(self.schedule(queries, aggregate=op))

    def embeddings(self, query) -> np.ndarray:
        """Enumerate the embeddings of one query as an (N, k) int32 matrix on
        the host, column c the vertex matched to pattern vertex c, rows in
        the order the reference engine emits them."""
        self._sct["queries"].inc()
        with self._query_span("embeddings", query=str(query)):
            return self._runner.run(self.compile(query, emit=True))

    def run_plans(self, plans: Sequence[WavePlan]) -> list:
        """Execute compiled plans (count, aggregate or emit; FSM's feed):
        one runs directly, several fuse through a forest cached on their
        canonical keys."""
        self._sct["queries"].inc()
        plans = list(plans)
        with self._query_span("run_plans", plans=len(plans)):
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
        """Session counters, the mesh's signature, the executable cache
        (``rebuilds`` = misses) and the runner's dispatch/sync counters."""
        cache = self.exec_cache.snapshot()
        return {**self._stats, "mesh": mesh_signature(self.mesh, self.config.device),
                "exec_cache": cache,
                "rebuilds": self.exec_cache.misses,
                "runner": dict(self._runner.stats)}
