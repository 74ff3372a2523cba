"""Typed metrics registry: counters, gauges, histograms, labeled series.

The registry is the single source of truth for every runtime counter the
mining pipeline keeps (``WaveRunner``/``ShardedWaveRunner``/``Miner``).
It is deliberately tiny and allocation-light — instruments are plain
``__slots__`` objects and an increment is one attribute add — because the
hot path (one ``inc`` per kernel dispatch / host sync) must cost no more
than the raw ``stats[...] += 1`` dict mutations it replaced.

Instruments
-----------

* ``Counter`` — monotone up-counter with an explicitly guarded ``dec``:
  decrements below zero raise instead of silently underflowing (the
  count-rides host-sync bookkeeping in ``mining.engine`` relies on this
  invariant).
* ``Gauge`` — last-written value (e.g. per-shard feed block width).
* ``Histogram`` — count/sum/min/max plus fixed exponential buckets; used
  for span durations and wavefront item sizes.

Labels
------

``registry.counter("shard_feed_items", shard=3)`` creates one instrument
per label set under a shared family name — the labeled-series form the
per-shard metrics use. ``series(name)`` returns the family as a dict
keyed by the sorted ``(key, value)`` label tuple.

The legacy ``WaveRunner.stats`` dict is a *derived view* over this
registry (``LegacyStatsView``): reads pull live instrument values, writes
set them, and the view is bit-identical to the dict the engine used to
mutate in place (golden-tested in tests/test_obs.py).
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import Callable

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LegacyStatsView"]


class Counter:
    """Up-counter. ``dec`` enforces a non-negative invariant: the engine's
    ride bookkeeping subtracts host syncs it knows it never paid, and a
    drift below zero is a bug to surface, not arithmetic to absorb."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += v

    def dec(self, v: int = 1) -> None:
        nv = self.value - v
        if nv < 0:
            raise ValueError(
                f"counter underflow: dec({v}) from {self.value} — "
                "bookkeeping drift (see mining.engine count-rides path)")
        self.value = nv

    def set(self, v: int) -> None:
        """Explicit reset/write-through (legacy ``stats[...] = n`` sites)."""
        self.value = v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, v=1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


# default exponential bucket bounds — wide enough for item counts and for
# seconds-scale durations alike (values land in the first bucket whose
# bound is >= v; the last bucket is +inf)
_DEFAULT_BUCKETS = tuple(4.0 ** e for e in range(-8, 9))


class Histogram:
    """count/sum/min/max + fixed exponential buckets (no per-sample
    storage, so observing is O(#buckets) worst case and allocation-free)."""

    __slots__ = ("count", "total", "min", "max", "bounds", "buckets")

    def __init__(self, bounds=_DEFAULT_BUCKETS) -> None:
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max, "mean": self.mean}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> instrument (or labeled family of instruments).

    A name is bound to one instrument type on first use; re-requesting it
    as a different type raises (typed registry, not a loose dict). Lookups
    are cached per (name, labels) so hot-path calls after the first are a
    single dict get + attribute add.
    """

    def __init__(self) -> None:
        self._metrics: dict[tuple, object] = {}   # (name, labels) -> inst
        self._types: dict[str, str] = {}          # name -> kind

    # ------------------------------------------------------------- access
    def _get(self, kind: str, name: str, labels: dict, **ctor):
        key = (name, tuple(sorted(labels.items())))
        inst = self._metrics.get(key)
        if inst is not None:
            if self._types[name] != kind:
                raise TypeError(f"metric {name!r} is a "
                                f"{self._types[name]}, requested {kind}")
            return inst
        prev = self._types.setdefault(name, kind)
        if prev != kind:
            raise TypeError(f"metric {name!r} is a {prev}, requested {kind}")
        inst = self._metrics[key] = _KINDS[kind](**ctor)
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, bounds=None, **labels) -> Histogram:
        ctor = {"bounds": bounds} if bounds is not None else {}
        return self._get("histogram", name, labels, **ctor)

    # ------------------------------------------------------------ queries
    def series(self, name: str) -> dict:
        """All instruments of a family: {sorted (key, value) label tuple ->
        instrument} (empty labels -> the ``()`` entry)."""
        return {lk: inst for (n, lk), inst in self._metrics.items()
                if n == name}

    def value(self, name: str, **labels):
        key = (name, tuple(sorted(labels.items())))
        inst = self._metrics.get(key)
        return None if inst is None else inst.snapshot()

    def snapshot(self) -> dict:
        """{name: value} for unlabeled metrics; labeled families nest as
        {name: {"label=value,...": value}} (histograms as their summary
        dicts)."""
        out: dict = {}
        for (name, lk), inst in sorted(self._metrics.items()):
            v = inst.snapshot()
            if not lk:
                out[name] = v
            else:
                lab = ",".join(f"{k}={x}" for k, x in lk)
                out.setdefault(name, {})[lab] = v
        return out

    # ------------------------------------------------------------- export
    def prometheus_text(self, prefix: str = "mining_") -> str:
        """Prometheus text-exposition snapshot of every instrument.

        Counters/gauges emit one sample per label set; histograms emit the
        ``_count``/``_sum``/``_bucket{le=...}`` triplet. Metric names get
        ``prefix`` and non-identifier characters become underscores."""
        def sanitize(n: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_"
                           for c in n)

        lines: list[str] = []
        by_name: dict[str, list] = {}
        for (name, lk), inst in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append((lk, inst))
        for name, insts in by_name.items():
            kind = self._types[name]
            pname = prefix + sanitize(name)
            lines.append(f"# TYPE {pname} "
                         f"{'untyped' if kind == 'gauge' else kind}")
            for lk, inst in insts:
                lab = ",".join(f'{sanitize(k)}="{v}"' for k, v in lk)
                labp = "{" + lab + "}" if lab else ""
                if kind == "histogram":
                    cum = 0
                    for bound, c in zip(inst.bounds, inst.buckets):
                        cum += c
                        blab = (lab + "," if lab else "") + f'le="{bound}"'
                        lines.append(f"{pname}_bucket{{{blab}}} {cum}")
                    blab = (lab + "," if lab else "") + 'le="+Inf"'
                    lines.append(f"{pname}_bucket{{{blab}}} {inst.count}")
                    lines.append(f"{pname}_sum{labp} {inst.total}")
                    lines.append(f"{pname}_count{labp} {inst.count}")
                else:
                    lines.append(f"{pname}{labp} {inst.snapshot()}")
        return "\n".join(lines) + ("\n" if lines else "")


class LegacyStatsView(MutableMapping):
    """The engine's historical ``stats`` dict, derived live from a
    ``MetricsRegistry``.

    Every key maps to a getter (and optional setter) registered by the
    runner; iteration order is registration order, so ``dict(view)``
    reproduces the pre-registry dict bit-for-bit (golden-tested). Writes
    (``view["exec_misses"] = 0`` — a couple of legacy call sites) pass
    through to the backing instrument; deletes are not a thing stats ever
    supported and raise."""

    def __init__(self) -> None:
        self._getters: dict[str, Callable] = {}
        self._setters: dict[str, Callable] = {}

    def expose(self, key: str, getter: Callable,
               setter: Callable | None = None) -> None:
        self._getters[key] = getter
        if setter is not None:
            self._setters[key] = setter

    def expose_counter(self, key: str, registry: MetricsRegistry,
                       name: str | None = None) -> Counter:
        c = registry.counter(name or key)
        self.expose(key, lambda: c.value, c.set)
        return c

    def __getitem__(self, key):
        return self._getters[key]()

    def __setitem__(self, key, value) -> None:
        try:
            self._setters[key](value)
        except KeyError:
            raise KeyError(f"stats key {key!r} is not writable") from None

    def __delitem__(self, key) -> None:
        raise TypeError("stats keys cannot be deleted")

    def __iter__(self):
        return iter(self._getters)

    def __len__(self) -> int:
        return len(self._getters)

    def __repr__(self) -> str:
        return repr(dict(self))
