"""Load generator: client threads + the tick loop, with latency stats.

Drives a ``MiningService`` the way real traffic would: N client threads
submit requests (round-robin over a fixed list of query mixes, optionally
paced to a target qps) and park on ``result()``, while the generator's
main thread runs the service's tick loop until every request completed.
Because clients submit concurrently and ticks drain whole queues, the
service merges heterogeneous in-flight requests into shared forest
schedules — the cross-request-sharing behaviour the benchmark gates.

Latency is the request's own ``latency_s`` (submit -> completion, queue
wait included); the report carries p50/p99, achieved qps, and the
service's sharing/admission counters. Wall-clock numbers are
machine-dependent — ``benchmarks/ci_gate.py --serving`` gates them only
as RATIOS against a sequential single-session baseline.
"""
from __future__ import annotations

import threading
import time

from .service import MiningService

__all__ = ["LoadGenerator", "percentile"]


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]) of a non-empty sequence."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
    return float(xs[idx])


class LoadGenerator:
    """Threaded client traffic against one service.

    ``mixes`` is a list of request shapes, each either a query batch or a
    ``(queries, traffic_class)`` pair; request ``i`` (global order) uses
    ``mixes[i % len(mixes)]``. ``qps=None`` submits as fast as the
    clients can (burst — queues deepen, ticks merge maximally);
    a float paces each client to ``qps / clients`` submissions/s."""

    def __init__(self, service: MiningService, mixes, requests: int = 64,
                 clients: int = 4, qps: float | None = None,
                 timeout_s: float | None = None):
        if requests < 1 or clients < 1:
            raise ValueError("need requests >= 1 and clients >= 1")
        self.service = service
        self.mixes = [m if isinstance(m, tuple) and len(m) == 2
                      and isinstance(m[1], str) else (m, "default")
                      for m in mixes]
        self.requests = int(requests)
        self.clients = min(int(clients), self.requests)
        self.qps = qps
        self.timeout_s = timeout_s

    def _client(self, cid: int, out: list) -> None:
        interval = (self.clients / self.qps) if self.qps else 0.0
        nxt = time.monotonic()
        for i in range(cid, self.requests, self.clients):
            if interval:
                nxt += interval
                delay = nxt - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            queries, tc = self.mixes[i % len(self.mixes)]
            out.append(self.service.submit(queries, traffic_class=tc,
                                           timeout_s=self.timeout_s))

    def run(self) -> dict:
        """Generate the load; tick until every request completed."""
        per_client: list[list] = [[] for _ in range(self.clients)]
        threads = [threading.Thread(target=self._client, args=(c, per_client[c]),
                                    daemon=True)
                   for c in range(self.clients)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) or self.service.pending:
            if not self.service.tick()["requests"]:
                time.sleep(0.001)          # idle tick: let clients enqueue
        for t in threads:
            t.join()
        self.service.run_until_idle()
        wall = time.monotonic() - t0
        reqs = [r for sub in per_client for r in sub]
        lat = [r.latency_s for r in reqs if r.state == "done"]
        st = self.service.stats
        return {
            "requests": len(reqs),
            "completed": len(lat),
            "rejected": sum(r.state == "rejected" for r in reqs),
            "timeouts": sum(r.state == "timeout" for r in reqs),
            "failed": sum(r.state == "failed" for r in reqs),
            "wall_s": round(wall, 4),
            "qps": round(len(lat) / max(wall, 1e-9), 2),
            "p50_s": round(percentile(lat, 50), 5) if lat else None,
            "p99_s": round(percentile(lat, 99), 5) if lat else None,
            "feed_passes": {
                "independent": st["service_feed_passes_independent"],
                "fused": st["service_feed_passes_fused"]},
            "retraces": st["retraces"],
        }
