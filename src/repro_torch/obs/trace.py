"""Structured tracing: per-query span trees over the mining pipeline.

A ``Tracer`` records a tree of ``Span``s per traced query:

    query(triangle)
    ├─ compile
    ├─ schedule            (batch queries)
    └─ execute
       ├─ feed  L1         (one per edge-feed chunk: cap, items)
       │  └─ level L2 expand
       │     ├─ dispatch   (kernel dispatch + block_until_ready wall time)
       │     └─ level L3 count
       │        └─ dispatch
       └─ ...

Spans nest by wall time (children run inside their parent's interval), so
the tree exports directly to Chrome-trace/Perfetto "X" events
(``repro.obs.export``). Each span records ``perf_counter`` start/end,
a category, and free-form attributes — dispatch spans carry the op kind,
level, wavefront items, capacities and the executable-cache hit/miss bit.

Timing discipline: the engine only opens dispatch spans when the tracer
is *enabled*, and then follows the dispatch with ``block_until_ready`` so
the span measures real device wall time instead of async dispatch time.
Disabled (the default) the engine takes the untraced branch — no spans,
no synchronization, no extra kernel dispatches (tested in
tests/test_obs.py).

``self_seconds`` is a span's exclusive time (duration minus direct
children), which makes per-level attribution sum-consistent: the exclusive
times of every span under ``execute`` add up to the query's execute wall
time minus untracked gaps.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["Span", "Tracer"]


class Span:
    """One timed node of the trace tree."""

    __slots__ = ("name", "cat", "attrs", "t0", "t1", "children")

    def __init__(self, name: str, cat: str = "span",
                 attrs: dict | None = None):
        self.name = name
        self.cat = cat
        self.attrs = attrs or {}
        self.t0 = time.perf_counter()
        self.t1 = None
        self.children: list[Span] = []

    def close(self) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    @property
    def self_seconds(self) -> float:
        """Exclusive time: duration minus direct children's durations."""
        return self.seconds - sum(c.seconds for c in self.children)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str):
        """All descendant spans (incl. self) with ``name``."""
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat,
                "t0": self.t0, "seconds": self.seconds,
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"{self.seconds * 1e3:.3f}ms, "
                f"{len(self.children)} children)")


class Tracer:
    """Span-tree recorder. ``enabled=False`` (the default) records nothing
    and ``span()`` degenerates to a no-op context manager; finished root
    spans accumulate in ``self.finished``."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.finished: list[Span] = []
        self._stack: list[Span] = []

    # ----------------------------------------------------------- recording
    @property
    def current(self) -> Span | None:
        return self._stack[-1] if self._stack else None

    @contextmanager
    def span(self, name: str, cat: str = "span", **attrs):
        if not self.enabled:
            yield None
            return
        sp = Span(name, cat, attrs)
        parent = self.current
        if parent is not None:
            parent.children.append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            sp.close()
            self._stack.pop()
            if parent is None:
                self.finished.append(sp)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker attached to the current span."""
        if not self.enabled or not self._stack:
            return
        sp = Span(name, "event", attrs)
        sp.t1 = sp.t0
        self._stack[-1].children.append(sp)

    # ------------------------------------------------------------- queries
    def spans(self, name: str | None = None) -> list[Span]:
        """All recorded spans (across finished roots), depth-first;
        filtered by ``name`` when given."""
        out: list[Span] = []
        for root in self.finished:
            out.extend(root.walk() if name is None else root.find(name))
        return out

    def seconds(self, name: str) -> float:
        """Total wall seconds across every span named ``name``."""
        return sum(s.seconds for s in self.spans(name))

    def last(self, name: str) -> Span | None:
        sp = self.spans(name)
        return sp[-1] if sp else None

    def clear(self) -> None:
        self.finished.clear()
        self._stack.clear()

    # ---------------------------------------------------------- aggregates
    def level_seconds(self) -> dict[str, float]:
        """Exclusive (self) seconds aggregated by span name — the
        "where did this query's time go" per-level accounting. Summing the
        values over all spans of a query reproduces the query wall time
        minus untracked host gaps."""
        agg: dict[str, float] = {}
        for sp in self.spans():
            agg[sp.name] = agg.get(sp.name, 0.0) + sp.self_seconds
        return agg
