"""Mining telemetry: metrics registry + structured tracing + exporters.

The counterpart of ``repro.obs``: one ``Telemetry`` object per session.

* ``telemetry.metrics`` — a ``MetricsRegistry`` of typed counters /
  gauges / histograms. Always on: the registry is the backing store of
  the engine's ``stats`` dicts (derived views over its counters).
* ``telemetry.tracer`` — a ``Tracer`` producing per-query span trees
  (query → compile/schedule/execute → feed and per-level spans → one
  ``dispatch`` span per level call, ended by ``torch.cuda.synchronize()``
  on a card so it holds the call's device time). Off by default: a
  disabled tracer records nothing, adds no synchronize and no launch.
* exporters — Chrome-trace/Perfetto JSON, a Prometheus text snapshot, and
  ``snapshot()`` (metrics + per-span aggregates).

``Telemetry()`` is disabled tracing + live metrics; ``Miner`` shares one
``Telemetry`` with its runner so a query's counters land in one place.

``Telemetry.torch_profile(logdir)`` takes the place of the JAX package's
``jax_profile``: it wraps a query in ``torch.profiler`` (device kernels
included on a card) and writes one Chrome trace to ``logdir``.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from .export import chrome_trace, prometheus_text, write_chrome_trace
from .registry import (Counter, Gauge, Histogram, LegacyStatsView,
                       MetricsRegistry)
from .trace import Span, Tracer

__all__ = ["Telemetry", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LegacyStatsView", "Span", "Tracer", "chrome_trace",
           "prometheus_text", "write_chrome_trace"]


class Telemetry:
    """Registry + tracer + export surface for one mining session."""

    def __init__(self, enabled: bool = False,
                 registry: MetricsRegistry | None = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(enabled=enabled)

    # ------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def enable(self) -> None:
        self.tracer.enabled = True

    def disable(self) -> None:
        self.tracer.enabled = False

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Everything an external consumer wants in one dict: the metrics
        snapshot, per-span-name wall/self-time aggregates, and the root
        span summaries (name, seconds, #children)."""
        spans: dict[str, dict] = {}
        for sp in self.tracer.spans():
            agg = spans.setdefault(sp.name, {"count": 0, "seconds": 0.0,
                                             "self_seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += sp.seconds
            agg["self_seconds"] += sp.self_seconds
        return {
            "metrics": self.metrics.snapshot(),
            "spans": spans,
            "roots": [{"name": r.name, "cat": r.cat,
                       "seconds": r.seconds,
                       "spans": sum(1 for _ in r.walk())}
                      for r in self.tracer.finished],
        }

    def chrome_trace(self) -> dict:
        return chrome_trace(self.tracer)

    def write_trace(self, path):
        return write_chrome_trace(path, self.tracer, self.metrics)

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


# module-level disabled singleton: runners built without a session share
# this so bare WaveRunner construction never allocates tracer state; note
# its *registry* is still per-runner (each runner builds its own
# Telemetry unless handed one — see WaveRunner.__init__)
def null_telemetry() -> Telemetry:
    return Telemetry(enabled=False)
