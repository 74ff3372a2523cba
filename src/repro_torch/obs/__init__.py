"""Mining telemetry: metrics registry + structured tracing + exporters.

The counterpart of ``repro.obs``: one ``Telemetry`` object per session.

* ``telemetry.metrics`` — a ``MetricsRegistry`` of typed counters /
  gauges / histograms. Always on: the registry is the backing store of
  the engine's ``stats`` dicts (derived views over its counters), of the
  feed's ``feed_h2d_bytes`` and of ``kernel_launches{symbol=...}``, the
  hand-kernel launches of ``kernels/build.py``.
* ``telemetry.tracer`` — a ``Tracer`` producing per-query span trees
  (query → compile/schedule/execute → feed and per-level spans → the
  ``dispatch`` span of each level call, and the ``host`` spans ``launch``,
  ``sync``, ``slice`` and ``upload`` where the host launches, waits on the
  card, cuts the next wave and uploads the feed). Every span is host time
  and none synchronizes; its times go on ``torch.profiler``'s clock by
  ``tracer.clock_offset_ns``. Off by default: a disabled tracer records
  nothing and the engine builds no span.
* exporters — Chrome-trace/Perfetto JSON on the profiler's clock and a
  Prometheus text snapshot.

``Telemetry()`` is disabled tracing + live metrics; ``Miner`` shares one
``Telemetry`` with its runner so a query's counters land in one place.
``activate(tel)``, entered by ``WaveRunner.run`` and ``run_set``, makes a
session's telemetry the one ``active()`` returns to a layer with no session
at hand (``kernels/build.py``'s ``launch``), in this thread and context.

``Telemetry.torch_profile(logdir)`` takes the place of the JAX package's
``jax_profile``: it wraps a query in ``torch.profiler`` (device kernels
included on a card) and writes one Chrome trace to ``logdir``.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from contextvars import ContextVar

import torch

from .export import chrome_trace, prometheus_text, write_chrome_trace
from .registry import (Counter, Gauge, Histogram, LegacyStatsView,
                       MetricsRegistry)
from .trace import NO_SPAN, Span, Tracer

__all__ = ["Telemetry", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LegacyStatsView", "NO_SPAN", "Span", "Tracer", "activate", "active",
           "chrome_trace", "prometheus_text", "write_chrome_trace"]


class Telemetry:
    """Registry + tracer + export surface for one mining session."""

    def __init__(self, enabled: bool = False,
                 registry: MetricsRegistry | None = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=enabled)
        self._launches: dict[str, Counter] = {}

    # ------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def enable(self) -> None:
        self.tracer.enabled = True

    def disable(self) -> None:
        self.tracer.enabled = False

    # ------------------------------------------------------------ counters
    def launched(self, symbol: str) -> None:
        """Count one launch of the hand kernel ``symbol``
        (``kernel_launches{symbol=...}``)."""
        c = self._launches.get(symbol)
        if c is None:
            c = self._launches[symbol] = self.metrics.counter("kernel_launches",
                                                              symbol=symbol)
        c.value += 1

    # ------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        return chrome_trace(self.tracer)

    def write_trace(self, path, base_ns: int = 0):
        """The span trees as Chrome-trace JSON at ``path``, ``ts`` in µs on
        the profiler's clock after ``base_ns`` (a ``torch.profiler``
        trace's ``baseTimeNanoseconds`` lays both on one timeline)."""
        return write_chrome_trace(path, self.tracer, self.metrics, base_ns=base_ns)

    def prometheus_text(self, prefix: str = "mining_") -> str:
        return self.metrics.prometheus_text(prefix=prefix)

    # ---------------------------------------------------- torch profiler
    @contextmanager
    def torch_profile(self, logdir: str | None, device=None):
        """``torch.profiler`` around a query, the counterpart of the JAX
        package's ``jax_profile``: ``with tel.torch_profile("/tmp/prof",
        miner.config.device): miner.count(...)``. CPU activity always, CUDA
        activity when ``device`` is a card (None: when torch sees one); on
        exit the trace is written to ``<logdir>/trace.json``. ``logdir``
        None or empty is a no-op that yields None, so callers can pass the
        CLI flag through unconditionally."""
        if not logdir:
            yield None
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        on_card = (torch.cuda.is_available() if device is None
                   else torch.device(device).type == "cuda")
        if on_card:
            if not torch.cuda.is_available():
                raise RuntimeError(f"torch_profile on {device!r}: torch sees no CUDA device")
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield logdir
            if on_card:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_ACTIVE: ContextVar[Telemetry | None] = ContextVar("repro_torch_telemetry", default=None)


# ``active()``: the telemetry of the session whose query runs in this thread
# and context, None outside one (``kernels/build.py``'s ``launch`` counts and
# spans its launches on it); the ContextVar's own getter, no Python frame
active = _ACTIVE.get


@contextmanager
def activate(telemetry: Telemetry):
    """Make ``telemetry`` the ``active()`` one inside the block; the one
    before it is restored on exit (a query run inside another's keeps
    its own)."""
    token = _ACTIVE.set(telemetry)
    try:
        yield telemetry
    finally:
        _ACTIVE.reset(token)
