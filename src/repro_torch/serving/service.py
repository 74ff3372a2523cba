"""``MiningService``: the tick loop — admission, batching, execution.

One service owns a graph, a ``WorkerPool`` of resident ``Miner`` sessions
(one per traffic class), a graph-version-keyed ``ResultCache`` and an
in-flight request queue. ``submit()`` is thread-safe and non-blocking;
``tick()`` — the single-consumer scheduling round — drains the queue,
merges every drained request's queries into ONE ``PlanForest`` schedule
per traffic class (cross-request sharing), executes it, and routes the
per-query results back to each request. See the package docstring
(``repro_torch.serving``) for the full contract.

Cross-request sharing accounting (the gate metric): per executed batch,

* ``service_feed_passes_independent`` — the sum over the batch's requests
  of the feed passes each request's *own* fused schedule would cost if
  executed alone (``worker.schedule(request.queries)`` — already each
  request's best case);
* ``service_feed_passes_fused`` — the merged batch forest's actual feed
  passes.

fused < independent whenever a tick merged two or more requests — the
"cross-REQUEST sharing, not just cross-pattern" fact ``ci_gate.py
--serving`` gates exactly.

Value traffic (SVPU, §IV-E): ``submit(..., aggregate="sum"|"max"|"min")``
routes the request onto the ``values`` traffic class (unless the caller
pins one explicitly) and executes via ``Miner.aggregate_many``. Aggregate
requests batch exactly like count requests — one merged forest per
(traffic class, op) group — and their results live in the same
graph-version-keyed cache under op-tagged keys, so a weighted SUM and an
unweighted count over the same pattern never collide.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Sequence

from repro_torch.graph.csr import CSRGraph
from repro_torch.mining.plan import AGG_OPS, Motif, Pattern, resolve_query
from repro_torch.obs import Telemetry
from .cache import ResultCache
from .pool import DEFAULT_CLASS, WorkerPool, WorkerSpec
from .request import ServiceRequest

__all__ = ["MiningService", "ServiceConfig", "VALUES_CLASS"]

# Traffic class aggregate submissions default onto. The pool falls back
# to its first spec for classes without a dedicated worker, so services
# configured before the value plane existed serve it unchanged.
VALUES_CLASS = "values"


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Every service knob in one frozen config (``MiningService(g,
    **kwargs)`` is sugar that builds/extends one, mirroring ``Miner``).

    ``telemetry`` is the SERVICE's observability (tick spans, queue
    gauges, latency histograms); each worker session keeps its own
    (``WorkerSpec.config.telemetry``) so session registries never alias.
    """

    max_in_flight: int = 64           # admission bound on queued requests
    timeout_s: float | None = None    # default per-request deadline
    cache_results: bool = True        # graph-version-keyed result cache
    cache_entries: int = 1024         # result-cache LRU cap
    workers: tuple[WorkerSpec, ...] = (WorkerSpec(),)
    telemetry: Telemetry | None = dataclasses.field(
        default=None, compare=False, repr=False)


class MiningService:
    """Concurrent mining service over a pool of resident sessions.

    Thread contract: ``submit`` may be called from any thread; ``tick``
    (and ``set_graph``) must run on ONE service thread — the tick loop is
    the single consumer, exactly as each ``Miner`` is single-threaded
    with concurrency layered above it.
    """

    def __init__(self, graph: CSRGraph, config: ServiceConfig | None = None,
                 telemetry: Telemetry | None = None, **overrides):
        if telemetry is not None:
            overrides["telemetry"] = telemetry
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.telemetry = (config.telemetry if config.telemetry is not None
                          else Telemetry())
        reg = self.telemetry.metrics
        self._submitted = reg.counter("service_requests")
        self._completed = reg.counter("service_completed")
        self._rejected = reg.counter("service_rejected")
        self._timeouts = reg.counter("service_timeouts")
        self._failed = reg.counter("service_failed")
        self._ticks = reg.counter("service_ticks")
        self._queries = reg.counter("service_queries")
        self._feed_indep = reg.counter("service_feed_passes_independent")
        self._feed_fused = reg.counter("service_feed_passes_fused")
        self._depth = reg.gauge("service_queue_depth")
        self._version_g = reg.gauge("service_graph_version")
        self._batch_h = reg.histogram("service_batch_requests")
        self.version = 0
        self._lock = threading.Lock()
        self._queue: deque[ServiceRequest] = deque()
        self._ids = itertools.count()
        self.pool = WorkerPool(graph, config.workers)
        self.cache = (ResultCache(config.cache_entries, reg)
                      if config.cache_results else None)

    # ------------------------------------------------------------- submit
    def submit(self, queries, traffic_class: str | None = None,
               timeout_s: float | None = None,
               aggregate: str | None = None) -> ServiceRequest:
        """Enqueue one request (any thread, non-blocking).

        ``queries`` is one query (name / ``Pattern`` / ``Motif``) or a
        sequence; resolution happens here so the queue, the cache and the
        batcher all speak hashable resolved queries. ``aggregate`` turns
        the request into a weighted-value query (``Miner.aggregate_many``
        semantics) and defaults its traffic class to ``values``.
        Admission control: with ``max_in_flight`` requests already queued
        the request is REJECTED immediately (completed handle,
        ``result()`` raises) — the clean back-pressure path, never an
        unbounded queue."""
        if aggregate is not None and aggregate not in AGG_OPS:
            raise ValueError(
                f"aggregate must be one of {AGG_OPS}, got {aggregate!r}")
        if traffic_class is None:
            traffic_class = (VALUES_CLASS if aggregate is not None
                             else DEFAULT_CLASS)
        if isinstance(queries, (str, Pattern, Motif)):
            queries = (queries,)
        resolved = tuple(resolve_query(q) for q in queries)
        if timeout_s is None:
            timeout_s = self.config.timeout_s
        req = ServiceRequest(next(self._ids), resolved, traffic_class,
                             timeout_s, aggregate=aggregate)
        self._submitted.inc()
        self._queries.inc(len(resolved))
        with self._lock:
            if len(self._queue) >= self.config.max_in_flight:
                self._rejected.inc()
                req._finish("rejected", error=RuntimeError(
                    f"{len(self._queue)} requests in flight "
                    f"(max_in_flight={self.config.max_in_flight})"))
                return req
            self._queue.append(req)
            self._depth.set(len(self._queue))
        return req

    # --------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One scheduling round (service thread only).

        Drain the queue; expire requests past their deadline; serve
        fully-cached requests; merge the remainder per traffic class into
        one forest schedule each and execute; route results; complete
        every drained request. Returns the tick summary."""
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
            self._depth.set(0)
        self._ticks.inc()
        tr = self.telemetry.tracer
        summary = {"requests": len(batch), "executed": 0, "cached": 0,
                   "timeouts": 0, "failed": 0,
                   "feed_passes": {"independent": 0, "fused": 0}}
        if not batch:
            return summary
        self._batch_h.observe(len(batch))
        with (tr.span("tick", cat="serve", requests=len(batch))
              if tr.enabled else nullcontext()):
            now = time.monotonic()
            groups: dict[tuple, list] = {}
            for req in batch:
                if req.expired(now):
                    self._timeouts.inc()
                    summary["timeouts"] += 1
                    req._finish("timeout")
                    continue
                # per-query cache probe: partial hits shrink the batch,
                # full hits skip execution entirely
                found = {}
                if self.cache is not None:
                    for q in req.queries:
                        hit, v = self.cache.get(
                            self.version, self._cache_key(req.aggregate, q))
                        if hit:
                            found[q] = v
                missing = [q for q in req.queries if q not in found]
                if not missing:
                    self._complete(req, found, from_cache=True)
                    summary["cached"] += 1
                    continue
                # counts and aggregates never share a forest: the group
                # key carries the op so each merged schedule is homogeneous
                groups.setdefault((req.traffic_class, req.aggregate),
                                  []).append((req, found, missing))
            for (tc, agg), group in groups.items():
                self._execute_group(tc, agg, group, summary)
        return summary

    @staticmethod
    def _cache_key(aggregate: str | None, q):
        """Result-cache key: op-tagged for aggregates so a weighted SUM
        and a count of the same pattern occupy distinct entries."""
        return q if aggregate is None else (aggregate, q)

    def _execute_group(self, tc: str, agg: str | None, group: list,
                       summary: dict) -> None:
        """Merge one (traffic class, op) group into one forest and run it."""
        tr = self.telemetry.tracer
        worker = self.pool.worker(tc)
        union = list(dict.fromkeys(
            q for _req, _found, missing in group for q in missing))
        # sharing accounting: each request alone vs the merged batch —
        # schedule() is forest-cached, so repeated mixes re-derive nothing
        indep = sum(
            worker.schedule(missing, aggregate=agg)
            .sharing_stats()["feed_passes"]["fused"]
            for _req, _found, missing in group)
        fused = (worker.schedule(union, aggregate=agg)
                 .sharing_stats()["feed_passes"]["fused"])
        self._feed_indep.inc(indep)
        self._feed_fused.inc(fused)
        summary["feed_passes"]["independent"] += indep
        summary["feed_passes"]["fused"] += fused
        try:
            with (tr.span(f"execute:{tc}", cat="serve",
                          requests=len(group), queries=len(union))
                  if tr.enabled else nullcontext()):
                counts = (worker.count_many(union) if agg is None
                          else worker.aggregate_many(union, op=agg))
        except Exception as e:           # noqa: BLE001 — routed per request
            for req, _found, _missing in group:
                self._failed.inc()
                summary["failed"] += 1
                req._finish("failed", error=e)
            return
        by_query = dict(zip(union, counts))
        if self.cache is not None:
            for q, v in by_query.items():
                self.cache.put(self.version, self._cache_key(agg, q), v)
        for req, found, _missing in group:
            self._complete(req, {**found, **by_query})
            summary["executed"] += 1

    def _complete(self, req: ServiceRequest, by_query: dict,
                  from_cache: bool = False) -> None:
        self._completed.inc()
        self.telemetry.metrics.histogram(
            "service_latency_seconds", cls=req.traffic_class).observe(
            time.monotonic() - req.submitted_at)
        req._finish("done", [by_query[q] for q in req.queries],
                    from_cache=from_cache)

    # -------------------------------------------------------- conveniences
    def query(self, queries, traffic_class: str | None = None,
              timeout_s: float | None = None,
              aggregate: str | None = None):
        """Synchronous submit + tick + result (single-threaded callers —
        e.g. ``launch/serve.py --mine`` round mode). Returns the result
        list for a sequence, the bare value for a single query."""
        single = isinstance(queries, (str, Pattern, Motif))
        req = self.submit(queries, traffic_class, timeout_s,
                          aggregate=aggregate)
        if not req.done:
            self.tick()
        res = req.result(0)
        return res[0] if single else res

    def run_until_idle(self, max_ticks: int = 10_000) -> int:
        """Tick until the queue is empty; returns ticks spent."""
        n = 0
        while self.pending and n < max_ticks:
            self.tick()
            n += 1
        return n

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---------------------------------------------------------- lifecycle
    def set_graph(self, graph: CSRGraph) -> None:
        """Swap the served graph (service thread only): bumps the result
        cache's version (old-version entries invalidated) and rebuilds
        every worker session against the new graph."""
        self.version += 1
        self._version_g.set(self.version)
        self.pool.set_graph(graph)
        if self.cache is not None:
            self.cache.invalidate(self.version)

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        reg = self.telemetry.metrics
        out = {k: reg.value(k) for k in (
            "service_requests", "service_completed", "service_rejected",
            "service_timeouts", "service_failed", "service_ticks",
            "service_queries", "service_feed_passes_independent",
            "service_feed_passes_fused")}
        out["version"] = self.version
        out["pending"] = self.pending
        out["workers"] = self.pool.stats()
        out["retraces"] = self.pool.retraces()
        if self.cache is not None:
            out["cache"] = self.cache.snapshot()
        return out

    def prometheus_text(self, prefix: str = "mining_") -> str:
        return self.telemetry.prometheus_text(prefix=prefix)

    def write_trace(self, path):
        return self.telemetry.write_trace(path)
