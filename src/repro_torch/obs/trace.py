"""Structured tracing: per-query span trees over the mining pipeline.

A ``Tracer`` records a tree of ``Span``s per traced query:

    query(triangle)
    ├─ compile
    ├─ schedule            (batch queries)
    └─ execute
       ├─ upload           (the feed's next chunk, one ahead: pin + H2D copy)
       ├─ feed  L1         (one per edge-feed chunk: cap, items)
       │  └─ L2:expand
       │     ├─ dispatch   (the level body's torch ops)
       │     │  └─ launch  (one per hand-kernel launch: symbol)
       │     ├─ sync       (the level's meta read: the host waits on the card)
       │     ├─ slice      (the torch ops that cut the next wave's chunk)
       │     └─ L3:count
       │        └─ dispatch
       │           └─ launch
       └─ finalize
          └─ sync          (the partials' read)

Spans nest by wall time (children run inside their parent's interval), so
the tree exports directly to Chrome-trace/Perfetto "X" events
(``repro_torch.obs.export``). Each span records ``perf_counter_ns`` start
and end, a category, and free-form attributes: dispatch spans carry the op
kind, level, wavefront items, capacities and the executable-cache hit bit.
The tracer keeps a span as one row of flat lists, and builds the ``Span``
trees only when they are read (``finished``, ``spans``, ``last``), so a
traced level loop allocates no object a span.
``upload``, ``launch``, ``sync`` and ``slice`` share the category ``host``.

Timing discipline: every span is host time and none synchronizes, so a
traced run overlaps the card as an untraced one does; the card's time comes
from the device trace. ``Tracer.clock_offset_ns``, read when the tracer is
made and again when a root span opens, puts a span on the profiler's
clock: ``span.t0_ns + tracer.clock_offset_ns`` lies on the timeline of
``torch.profiler``'s kineto events (``time.time_ns()``, the Unix epoch in
ns). Disabled (the default) the engine opens no span and builds no name or
attribute for one.

``self_seconds`` is a span's exclusive time (duration minus direct
children), which makes per-level attribution sum-consistent: the exclusive
times of every span under ``execute`` add up to the query's execute wall
time minus untracked gaps.
"""
from __future__ import annotations

import time
from array import array

__all__ = ["Span", "Tracer"]


def _clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the perf counter read on
    both sides of the epoch read."""
    a = time.perf_counter_ns()
    t = time.time_ns()
    b = time.perf_counter_ns()
    return t - (a + b) // 2


class Span:
    """One timed node of a finished trace tree, built from the tracer's rows
    when the tree is read (``Tracer.finished``)."""

    __slots__ = ("name", "cat", "attrs", "t0_ns", "t1_ns", "children")

    def __init__(self, name: str, cat: str, attrs: dict, t0_ns: int, t1_ns: int):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.children: list[Span] = []

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

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

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"{self.seconds * 1e3:.3f}ms, "
                f"{len(self.children)} children)")


class _NoSpan:
    """The disabled tracer's span context: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Open:
    """The enabled tracer's one span context: ``__enter__`` opens the span
    ``Tracer.span`` just named, ``__exit__`` closes the innermost open one."""

    __slots__ = ("_tr",)

    def __init__(self, tracer: "Tracer"):
        self._tr = tracer

    def __enter__(self) -> None:
        tr = self._tr
        name, cat, attrs = tr._pending
        stack = tr._stack
        if stack:
            tr._parent.append(stack[-1])
        else:
            tr._parent.append(-1)
            tr.clock_offset_ns = _clock_offset_ns()
        stack.append(len(tr._t0))
        tr._name.append(name)
        tr._cat.append(cat)
        tr._attrs.append(attrs)
        tr._t1.append(-1)
        tr._t0.append(time.perf_counter_ns())

    def __exit__(self, *exc) -> None:
        tr = self._tr
        tr._t1[tr._stack.pop()] = time.perf_counter_ns()


class Tracer:
    """Span-tree recorder. ``enabled=False`` (the default) records nothing
    and ``span()`` returns a shared no-op context.

    A span is one row of parallel lists (name, category, attributes, and
    arrays of its start and end in perf-counter ns and its parent row),
    written as it opens and closes: no object a span but its attributes, so
    a traced level loop gives the garbage collector nothing to walk and
    keeps little memory. ``finished`` builds the ``Span`` trees of the closed
    root spans when it is read."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled      # a plain attribute: read at every span site
        # read again as each root span opens, so a tracer enabled later, or
        # long after, stays on the profiler's clock
        self.clock_offset_ns = _clock_offset_ns()
        self._open = _Open(self)
        self.clear()

    # ----------------------------------------------------------- recording
    def span(self, name: str, cat: str = "span", **attrs):
        """``with tracer.span(name, cat, **attrs): ...`` records one span
        around the block; a no-op with tracing off."""
        if not self.enabled:
            return NO_SPAN
        self._pending = (name, cat, attrs or None)
        return self._open

    def clear(self) -> None:
        """Drop every recorded span (open ones too)."""
        self._name: list[str] = []
        self._cat: list[str] = []
        self._attrs: list[dict | None] = []     # None: no attribute
        self._t0 = array("q")
        self._t1 = array("q")           # -1 while open
        self._parent = array("q")       # -1: a root
        self._stack: list[int] = []
        self._pending = None

    # ------------------------------------------------------------- queries
    @property
    def finished(self) -> list[Span]:
        """The closed root spans' trees, in the order they opened."""
        nodes: list[Span | None] = [None] * len(self._t0)
        roots = []
        for i, (t1, parent) in enumerate(zip(self._t1, self._parent)):
            if t1 < 0:
                continue
            sp = nodes[i] = Span(self._name[i], self._cat[i], self._attrs[i] or {},
                                 self._t0[i], t1)
            if parent < 0:
                roots.append(sp)
            elif nodes[parent] is not None:
                nodes[parent].children.append(sp)
        return roots

    def spans(self, name: str | None = None) -> list[Span]:
        """All recorded spans (across finished roots), depth-first;
        filtered by ``name`` when given."""
        out: list[Span] = []
        for root in self.finished:
            out.extend(root.walk() if name is None else root.find(name))
        return out

    def last(self, name: str) -> Span | None:
        sp = self.spans(name)
        return sp[-1] if sp else None

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
