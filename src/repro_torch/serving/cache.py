"""Graph-version-keyed result cache for the mining service.

Entries are keyed ``(graph_version, resolved_query)`` — per *query*, not
per request, so heterogeneous requests share hits (request {T, 4C} warms
request {4C} even though their batches differ). Resolved queries are
frozen ``Pattern``/``Motif`` dataclasses, hashable and stable across
submissions, which is exactly why ``MiningService.submit`` resolves them
up front.

A graph swap bumps the service's version; ``invalidate()`` then drops
every entry from older versions (counts are facts about one graph, never
transferable). Bounded LRU: the cap evicts oldest-touched entries so a
long-running service with a churning query population cannot grow without
bound.

Counters land in the service's ``MetricsRegistry`` (``repro.obs``):
``service_cache_hits`` / ``service_cache_misses`` /
``service_cache_invalidations`` — the gate facts ``ci_gate.py --serving``
checks exactly.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.obs import MetricsRegistry

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU of per-query results, keyed by graph version."""

    def __init__(self, entries: int = 1024,
                 metrics: MetricsRegistry | None = None):
        if entries < 1:
            raise ValueError("ResultCache needs entries >= 1")
        self.cap = int(entries)
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        reg = metrics if metrics is not None else MetricsRegistry()
        self.hits = reg.counter("service_cache_hits")
        self.misses = reg.counter("service_cache_misses")
        self.invalidations = reg.counter("service_cache_invalidations")

    def get(self, version: int, query) -> tuple[bool, object]:
        """(hit?, value) — counts the lookup either way."""
        key = (version, query)
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits.inc()
            return True, self._entries[key]
        self.misses.inc()
        return False, None

    def put(self, version: int, query, value) -> None:
        key = (version, query)
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)

    def invalidate(self, current_version: int) -> int:
        """Drop every entry from a version older than ``current_version``;
        returns (and counts) how many were dropped."""
        stale = [k for k in self._entries if k[0] < current_version]
        for k in stale:
            del self._entries[k]
        if stale:
            self.invalidations.inc(len(stale))
        return len(stale)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits.value,
                "misses": self.misses.value,
                "invalidations": self.invalidations.value}
