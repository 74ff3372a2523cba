"""Trace/metrics exporters: Chrome-trace (Perfetto) JSON and Prometheus
text snapshots.

``chrome_trace`` converts a ``Tracer``'s finished span trees into the
Chrome Trace Event Format (the ``traceEvents`` array of "X" complete
events, microsecond timestamps) that chrome://tracing and
https://ui.perfetto.dev load directly. Span attributes ride in ``args``;
each root span gets its own ``tid`` so concurrent queries lay out as
separate tracks.

Timestamps are on the profiler's clock (``Tracer.clock_offset_ns``), in
microseconds after ``base_ns`` (written as ``baseTimeNanoseconds``, as
``torch.profiler``'s Chrome traces write theirs): given the base of a
``torch.profiler`` trace of the same run, a span's ``ts`` equals the
profiler's ``ts`` of the same instant, so the two files' ``traceEvents``
merge into one Perfetto timeline (``launch/mine.py --trace OUT.json
--torch-profile LOGDIR`` writes both so).

``write_chrome_trace`` is the ``--trace out.json`` backend of
``launch/mine.py`` and ``launch/serve.py``. The Prometheus text form
lives on ``MetricsRegistry.prometheus_text`` and is re-exported here for
symmetry.
"""
from __future__ import annotations

import json
from pathlib import Path

from .registry import MetricsRegistry
from .trace import Span, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text"]


def _events(span: Span, pid: int, tid: int, shift_ns: int, out: list) -> None:
    out.append({
        "name": span.name,
        "cat": span.cat,
        "ph": "X",
        "ts": (span.t0_ns + shift_ns) / 1e3,     # Chrome trace wants microseconds
        "dur": max(span.seconds, 0.0) * 1e6,
        "pid": pid,
        "tid": tid,
        "args": {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                     else str(v)) for k, v in span.attrs.items()},
    })
    for c in span.children:
        _events(c, pid, tid, shift_ns, out)


def chrome_trace(tracer: Tracer, pid: int = 1, base_ns: int = 0) -> dict:
    """Chrome Trace Event Format document for a tracer's finished spans,
    ``ts`` in microseconds on the profiler's clock after ``base_ns``."""
    events: list[dict] = []
    for tid, root in enumerate(tracer.finished, start=1):
        _events(root, pid, tid, tracer.clock_offset_ns - base_ns, events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base_ns,
        "otherData": {"exporter": "repro_torch.obs",
                      "spans": len(events)},
    }


def write_chrome_trace(path, tracer: Tracer, registry=None, base_ns: int = 0) -> Path:
    """Write the Chrome-trace JSON (plus a metrics snapshot when a
    registry is given) to ``path``; returns the path."""
    doc = chrome_trace(tracer, base_ns=base_ns)
    if registry is not None:
        doc["otherData"]["metrics"] = registry.snapshot()
    p = Path(path)
    p.write_text(json.dumps(doc, indent=1))
    return p


def prometheus_text(registry: MetricsRegistry,
                    prefix: str = "mining_") -> str:
    return registry.prometheus_text(prefix=prefix)
