"""Reduction of ``torch.profiler`` runs to what the metric readers need.

A traced run profiles each call of a pass on its own (on the card with CUDA
activity alone: the kernels, copies and sets, and the host's CUDA runtime
calls; the CPU's aten events would multiply the trace and slow the pass
several times over). ``summarize(events, label)`` takes one call's events
straight from the profiler's kineto results (no ``FunctionEvent`` objects,
no trace file) and keeps, inside the call's extent (from its first event's
start to its last one's end, on the thread that ran it and on the device):

* the device's activity intervals (kernels, copies, sets; a CUDA-side user
  annotation is no activity), merged, and their total, the busy time;
* each kernel's summed time by name (copies and sets are not kernels);
* the device's idle gaps, each named by the call's ``label`` and by what
  the host was doing at its middle: the innermost profiler event open on
  the calling thread (a CUDA runtime call, or an aten op off the card),
  ``python`` where none was open.

``busy_ns(events)`` reads the busy time alone, for the untraced window's
end-to-end device metric: it reads no host event's fields. ``merge`` adds
the calls' summaries up. The busy-union arithmetic is the one
``chip_smoke.py`` sums per event, taken as a union so that overlapping
activity counts once.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class DeviceTrace:
    """The device's side of profiled calls (all times in ns)."""

    window_ns: int                          # the calls' extents, summed
    busy_ns: int                            # merged device activity in them
    kernel_ns: dict[str, int]               # summed kernel time by name
    idle_by_host: dict[str, int]            # idle time by what the host ran

    @property
    def kernel_total_ns(self) -> int:
        return sum(self.kernel_ns.values())

    def top_kernels(self, n: int = 10) -> list[list]:
        """[[name, seconds], ...]: the kernels that took most device time."""
        top = sorted(self.kernel_ns.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def top_idle(self, n: int = 10) -> list[list]:
        """[[host activity, seconds], ...]: where the device waited longest."""
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge (start, end) intervals into sorted disjoint ones."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: list[tuple[int, int]], t0: int, t1: int) -> list[tuple[int, int]]:
    """The idle intervals of [t0, t1] between merged busy intervals."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def name_gaps(idle: list[tuple[int, int]], host: list[tuple[int, int, str]],
              label: str) -> dict[str, int]:
    """Sum each idle gap's length under ``<label> > <innermost event>``, the
    host event open at its middle. ``host`` holds one thread's (start, end,
    name) events, which nest."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: dict[str, int] = defaultdict(int)
    stack: list[tuple[int, int, str]] = []
    i = 0
    for s, e in sorted(idle):
        mid = (s + e) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        # an event that ended before ``mid`` may sit under one still open
        open_ = [h for h in stack if h[0] <= mid < h[1]]
        out[f"{label} > {open_[-1][2] if open_ else 'python'}"] += e - s
    return dict(out)


def summarize(events, label: str) -> DeviceTrace:
    """``events``: one profiled call's kineto events
    (``prof.profiler.kineto_results.events()``); ``label`` names the call.
    Each event's fields are read once: a call may hold millions."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    dev_rows, host_rows = [], []
    for ev in events:
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                s = ev.start_ns()
                dev_rows.append((s, s + ev.duration_ns(), ev.name()))
        else:
            s = ev.start_ns()
            host_rows.append((s, s + ev.duration_ns(), ev.name(), ev.start_thread_id()))
    # the calling thread holds most host events; the profiler's own threads
    # (buffer flushes) are no part of the call
    thread = Counter(t for *_, t in host_rows).most_common(1)[0][0] if host_rows else None
    main = [(s, e, n) for s, e, n, t in host_rows if t == thread]
    ends = [(s, e) for s, e, _ in dev_rows] + [(s, e) for s, e, _ in main]
    if not ends:
        raise ValueError(f"{label}: the profile holds no event")
    t0, t1 = min(s for s, _ in ends), max(e for _, e in ends)
    kernels: dict[str, int] = defaultdict(int)
    for s, e, name in dev_rows:
        if not name.startswith(_NOT_KERNELS):
            kernels[name] += e - s
    busy = union([(s, e) for s, e, _ in dev_rows])
    idle = name_gaps(gaps(busy, t0, t1), main, label) if busy else {}
    return DeviceTrace(window_ns=t1 - t0, busy_ns=sum(e - s for s, e in busy),
                       kernel_ns=dict(kernels), idle_by_host=idle)


def busy_ns(events) -> int:
    """The merged device activity of one profile's ``events``, in ns."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    rows = []
    for ev in events:
        if ev.device_type() == cuda and not ev.is_user_annotation():
            s = ev.start_ns()
            rows.append((s, s + ev.duration_ns()))
    return sum(e - s for s, e in union(rows))


def merge(traces: list[DeviceTrace]) -> DeviceTrace:
    """The summaries of several profiled calls, added up."""
    kernels: dict[str, int] = defaultdict(int)
    idle: dict[str, int] = defaultdict(int)
    for t in traces:
        for k, v in t.kernel_ns.items():
            kernels[k] += v
        for k, v in t.idle_by_host.items():
            idle[k] += v
    return DeviceTrace(window_ns=sum(t.window_ns for t in traces),
                       busy_ns=sum(t.busy_ns for t in traces),
                       kernel_ns=dict(kernels), idle_by_host=dict(idle))
