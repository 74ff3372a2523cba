"""Concurrent mining service: cross-request forest batching over resident
``Miner`` sessions.

The session layer (``repro_torch.mining.session``) made one graph + one query
stream cheap; this package serves MANY concurrent query streams over one
graph — the paper's accelerator as a *workload* engine, amortizing across
requests the way ``PlanForest`` amortizes across patterns.

Tick / batching / admission contract
------------------------------------

* **submit** (any thread, non-blocking) — ``service.submit(queries,
  traffic_class=..., timeout_s=...)`` resolves the queries, applies
  admission control, and returns a ``ServiceRequest`` handle the caller
  parks on (``result()``). With ``max_in_flight`` requests already
  queued, the request is rejected immediately — typed
  ``RequestRejected`` on ``result()`` — never queued unboundedly.
* **tick** (ONE service thread — the single consumer; each ``Miner`` is
  single-threaded and the service layers concurrency above the sessions,
  not inside them) — drains the whole queue, expires requests whose
  deadline passed (``RequestTimeout``), serves fully-cached requests,
  then merges the remaining requests' queries *across requests*, per
  traffic class, into ONE ``PlanForest`` schedule
  (``Miner.schedule``/``count_many`` — the same shared-prefix fusion
  that merges patterns inside a batch) and executes it on that class's
  resident session. Results route back per request, per query.
  Counts are bit-identical to executing every request independently
  (the forest contract), and the merged schedule's feed passes are
  *strictly below* the sum of the requests' independent schedules
  whenever a tick merged two or more requests — the gated
  cross-request-sharing fact.
* **result cache** — per-(graph-version, query) LRU in front of the
  pool: repeated queries at one graph version are served without
  touching a session; ``set_graph`` bumps the version and invalidates.
* **value traffic** — ``submit(queries, aggregate="sum"|"max"|"min")``
  serves weighted-value queries (``Miner.aggregate_many``) on the
  ``values`` traffic class by default. Aggregate groups batch and cache
  exactly like count groups, under op-tagged cache keys, and never mix
  into a count group's forest.
* **worker pool** — one resident ``Miner`` per traffic class
  (``WorkerSpec``), mixing unsharded and mesh-sharded sessions
  (``MinerConfig(mesh=S)``); executable caches are topology-keyed, so
  steady state stays 0-retrace per session under any request mix.
* **observability** — the service *consumes* ``repro_torch.obs``: queue-depth
  gauges, per-class latency histograms, admission / cache / sharing
  counters in its ``MetricsRegistry`` (``service.prometheus_text()``),
  and per-tick span trees (``tick`` -> ``execute:<class>``) exported as
  Chrome-trace JSON. Each worker session keeps its own registry.

Entry points: ``launch/serve.py --mine`` drives rounds or a
``--qps/--clients`` load phase through one service;
``benchmarks/bench_serving.py`` is the gated load benchmark.
"""
from .cache import ResultCache
from .loadgen import LoadGenerator, percentile
from .pool import WorkerPool, WorkerSpec
from .request import (RequestFailed, RequestRejected, RequestTimeout,
                      ServiceRequest)
from .service import MiningService, ServiceConfig, VALUES_CLASS

__all__ = [
    "LoadGenerator", "MiningService", "RequestFailed", "RequestRejected",
    "RequestTimeout", "ResultCache", "ServiceConfig", "ServiceRequest",
    "VALUES_CLASS", "WorkerPool", "WorkerSpec", "percentile",
]
