#!/usr/bin/env python3
"""The span pass: the program's own host spans, laid on the device trace.

    python3 bench/spans.py --workload mico.cliques --seed 7

One process sets up one cell of ``BENCHMARK.json`` as ``bench/run.py``
does (the cell's graph in the order ``--seed`` draws, ``build_csr``, one
``repro_torch.Miner`` with its default config), runs one warm pass, one
pass whose calls each run under ``torch.profiler`` with CUDA activity alone
(the tracer off, as in ``run.py``'s traced window), and then the span pass:
one more such pass with the session's tracer (``repro_torch.obs``) on, so
that only the tracer differs between the two. After each call of the span
pass ``reduce_call`` keeps, and the tracer is cleared (a ``mico.cliques``
pass opens some 80K level spans):

* per span name: the spans' count, total and self (exclusive) ns;
* each device idle gap of the call, named by the innermost program span
  open at its middle (the span's perf-counter times plus the tracer's
  ``clock_offset_ns`` are on the profiler's clock), else ``unspanned``
  (none off the card, where no device activity bounds a gap);
* the counters' deltas over the call: hand-kernel launches
  (``kernel_launches``, all symbols) and bytes uploaded to the card
  (``feed_h2d_bytes``).

It prints the ``spans:`` lines (the span pass's wall against the profiled
pass's, host time by span, idle by call and innermost span) on standard
error and one JSON line on standard output: the six span metrics
(``metrics``), the two passes' walls and whether every pass gave the same
answers. A program whose tracer has no ``clock_offset_ns`` runs no span
pass and exits 3; without a card it exits 2 (``--device cpu`` runs here).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from bisect import bisect_right
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import devtrace, graphs, run  # noqa: E402

UNSPANNED = "unspanned"
# the spans below ``execute`` that name the level loop's host phases
LOOP = ("dispatch", "launch", "sync", "slice", "upload", "feed")


def is_level(name: str) -> bool:
    """A level span's name, ``L{l}:{kind}``."""
    return name[:1] == "L" and ":" in name and name[1:name.index(":")].isdigit()


@dataclasses.dataclass
class SpanTrace:
    """The span pass, or one call of it (times in ns)."""

    spans: dict[str, list[int]]         # name -> [count, total ns, self ns]
    idle_by_span: dict[str, int]        # "<call> > <span>" -> idle ns
    idle_ns: int                        # all the device's idle time
    launches: int                       # hand-kernel launches
    h2d_bytes: int                      # bytes uploaded to the card
    wall_s: float = 0.0                 # the calls' wall
    profiled_wall_s: float = 0.0        # a profiled pass's calls' wall

    def total(self, pick) -> tuple[int, int, int]:
        """(count, total ns, self ns) over the span names ``pick`` takes."""
        rows = [v for k, v in self.spans.items() if pick(k)]
        return tuple(sum(r[i] for r in rows) for i in range(3))

    @property
    def level_spans(self) -> int:
        return self.total(is_level)[0]

    def idle_share_under(self, pick) -> float:
        """The share of the idle time under the span names ``pick`` takes."""
        under = sum(ns for k, ns in self.idle_by_span.items()
                    if pick(k.rsplit(" > ", 1)[-1]))
        return under / self.idle_ns if self.idle_ns else 0.0

    def top_idle(self, n: int | None = None) -> list[list]:
        """[["<call> > <span>", seconds], ...], longest first (all: None)."""
        top = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def _innermost(roots: list, t: int) -> str:
    """The innermost span of the trees ``roots`` open at perf-counter time
    ``t``; ``UNSPANNED`` where none is. Siblings do not overlap."""
    name, level = UNSPANNED, roots
    while level:
        i = bisect_right(level, t, key=lambda s: s.t0_ns) - 1
        if i < 0 or t >= level[i].t1_ns:
            break
        name, level = level[i].name, level[i].children
    return name


def _walk(roots: list, out: dict) -> None:
    for sp in roots:
        row = out[sp.name]
        total = sp.t1_ns - sp.t0_ns
        row[0] += 1
        row[1] += total
        row[2] += total - sum(c.t1_ns - c.t0_ns for c in sp.children)
        _walk(sp.children, out)


def reduce_call(events, roots: list, offset_ns: int, label: str,
                launches: int = 0, h2d_bytes: int = 0) -> SpanTrace:
    """One span-pass call: ``events`` its kineto events, ``roots`` the
    tracer's finished span trees, ``offset_ns`` the tracer's clock offset,
    ``label`` the call's name. The call's extent runs from the first to the
    last of its device events, its calling thread's runtime calls and its
    spans."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    dev, host = [], []
    for ev in events:
        s = ev.start_ns()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                dev.append((s, s + ev.duration_ns()))
        else:
            host.append((s, s + ev.duration_ns(), ev.start_thread_id()))
    spans: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0])
    _walk(roots, spans)
    idle: dict[str, int] = defaultdict(int)
    idle_ns = 0
    if dev:     # off the card no device activity: no gap to name
        thread = Counter(t for *_, t in host).most_common(1)[0][0] if host else None
        ends = dev + [(s, e) for s, e, t in host if t == thread] + \
            [(r.t0_ns + offset_ns, r.t1_ns + offset_ns) for r in roots]
        t0, t1 = min(s for s, _ in ends), max(e for _, e in ends)
        for s, e in devtrace.gaps(devtrace.union(dev), t0, t1):
            idle[f"{label} > {_innermost(roots, (s + e) // 2 - offset_ns)}"] += e - s
            idle_ns += e - s
    return SpanTrace(spans=dict(spans), idle_by_span=dict(idle), idle_ns=idle_ns,
                     launches=launches, h2d_bytes=h2d_bytes)


def merge(calls: list[SpanTrace]) -> SpanTrace:
    spans: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0])
    idle: dict[str, int] = defaultdict(int)
    for c in calls:
        for k, v in c.spans.items():
            row = spans[k]
            for i in range(3):
                row[i] += v[i]
        for k, v in c.idle_by_span.items():
            idle[k] += v
    return SpanTrace(spans=dict(spans), idle_by_span=dict(idle),
                     idle_ns=sum(c.idle_ns for c in calls),
                     launches=sum(c.launches for c in calls),
                     h2d_bytes=sum(c.h2d_bytes for c in calls),
                     wall_s=sum(c.wall_s for c in calls))


def _counts(metrics) -> tuple[int, int]:
    """(hand-kernel launches, bytes uploaded to a card) so far; 0 for a
    counter the program does not keep."""
    launches = sum(c.value for c in metrics.series("kernel_launches").values())
    return launches, metrics.value("feed_h2d_bytes") or 0


def span_pass(session, calls: list, sync, activities) -> SpanTrace | None:
    """One pass of ``calls`` ([(label, thunk), ...]) with ``session``'s
    tracer on, each call under ``torch.profiler`` with ``activities`` and
    ended by ``sync()``, reduced and cleared at once; None when the session
    has no tracer on the profiler's clock. The tracer is left as it was."""
    import torch
    tel = getattr(session, "telemetry", None)
    tracer = getattr(tel, "tracer", None)
    if tracer is None or not hasattr(tracer, "clock_offset_ns"):
        return None
    was = tracer.enabled
    tracer.enabled = True
    tracer.clear()
    out = []
    try:
        for label, thunk in calls:
            n0, b0 = _counts(tel.metrics)
            with torch.profiler.profile(activities=activities) as prof:
                c0 = time.perf_counter()
                thunk()
                sync()
                wall = time.perf_counter() - c0
            n1, b1 = _counts(tel.metrics)
            call = reduce_call(prof.profiler.kineto_results.events(), tracer.finished,
                               tracer.clock_offset_ns, label, n1 - n0, b1 - b0)
            call.wall_s = wall
            out.append(call)
            del prof
            tracer.clear()
    finally:
        tracer.enabled = was
        tracer.clear()
    return merge(out)


# the span metrics, each over the span pass (one pass of the cell)
METRICS = ("engine.self_us", "engine.ops_us", "engine.sync_us", "kernels.launch_us",
           "kernels.launches", "feed.h2d_mib")


def metrics(t: SpanTrace) -> dict:
    """The span pass's metrics, None where it read nothing (no level span;
    off the card no launch and no upload):

    * ``engine.self_us``: the level spans' self time a level span, the
      engine's own Python (executable-cache lookup, level arguments,
      counters);
    * ``engine.ops_us``: ``dispatch`` and ``slice`` self time a level span,
      the level body's torch ops and the next wave's slicing, launches left
      out;
    * ``engine.sync_us``: ``sync`` time a level span, the host blocked on
      the card (a level's meta, a pack's total, an emit's rows, partials);
    * ``kernels.launch_us``: ``launch`` time a hand-kernel launch, the
      ctypes call and its stream lookup;
    * ``kernels.launches``: hand-kernel launches (``kernel_launches``);
    * ``feed.h2d_mib``: MiB uploaded to the card (``feed_h2d_bytes``)."""
    out = dict.fromkeys(METRICS)
    levels = t.level_spans
    row = lambda name: t.spans.get(name, [0, 0, 0])    # noqa: E731
    if levels:
        out["engine.self_us"] = t.total(is_level)[2] / 1e3 / levels
        out["engine.ops_us"] = (row("dispatch")[2] + row("slice")[2]) / 1e3 / levels
        out["engine.sync_us"] = row("sync")[1] / 1e3 / levels
    if t.launches:
        out["kernels.launch_us"] = row("launch")[1] / 1e3 / t.launches
        out["kernels.launches"] = t.launches
    if t.h2d_bytes:
        out["feed.h2d_mib"] = t.h2d_bytes / 2**20
    return out


def print_spans(t: SpanTrace, all_s: float) -> None:
    """The span pass on standard error: its calls' wall against the profiled
    pass's, where the level loop's time went by span, and the device's idle
    time by call and innermost span."""
    levels = t.level_spans or 1
    row = lambda name: t.spans.get(name, [0, 0, 0])    # noqa: E731
    us = {"self": t.total(is_level)[2], "dispatch": row("dispatch")[2],
          "slice": row("slice")[2], "sync": row("sync")[1], "launch": row("launch")[1]}
    us = {k: 1e-3 * v / levels for k, v in us.items()}
    loop = t.idle_share_under(lambda n: is_level(n) or n in LOOP)
    ratio = t.wall_s / t.profiled_wall_s if t.profiled_wall_s else float("nan")
    print(f"spans: pass calls {t.wall_s:.3f} s against a profiled pass's "
          f"{t.profiled_wall_s:.3f} s (x{ratio:.4f}), all {all_s:.3f} s; {levels} level "
          f"spans, {t.wall_s * 1e6 / levels:.2f} us of wall a level span: "
          + " + ".join(f"{k} {v:.2f}" for k, v in us.items())
          + f" = {sum(us.values()):.2f}; launches {t.launches}, h2d bytes {t.h2d_bytes}; "
          f"idle {t.idle_ns / 1e9:.4f} s, {100 * loop:.2f}% under the level loop's spans; "
          "idle s by call > span " + json.dumps(t.top_idle()), file=sys.stderr)
    print("spans: by name [count, total s, self s] " + json.dumps(
        {k: [v[0], v[1] / 1e9, v[2] / 1e9] for k, v in sorted(t.spans.items())}),
        file=sys.stderr)


def span_cell(workload: str, seed: int, device: str = "cuda",
              scale: float = 1.0) -> dict | None:
    """Set up ``workload`` as ``run.run_cell`` does, run its warm pass, one
    profiled pass and the span pass; the result object, or None where the
    program's tracer is not on the profiler's clock. ``device`` and
    ``scale`` are the tests' (``cpu`` and a small twin)."""
    import torch

    from repro_torch.graph.csr import build_csr
    from repro_torch.mining.session import Miner

    t_start = time.perf_counter()
    spec = run.load_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    entries = run._entries(traffic)
    on_card = torch.device(device).type == "cuda"
    edges, num_vertices = graphs.edges_of(
        config, scale, ROOT / "build" / "bench" if scale == 1.0 else None)
    graph = build_csr(graphs.shuffle(edges, seed), num_vertices=num_vertices,
                      undirected=True)
    session = Miner(graph) if on_card else Miner(graph, device=device)
    answers: list[list] = [[] for _ in entries]

    def call(i: int) -> None:
        answers[i].append(run._call(session, entries[i]))

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    act = torch.profiler.ProfilerActivity
    acts = [act.CUDA] if on_card else [act.CPU]
    for i in range(len(entries)):        # the warm pass
        call(i)
    with torch.profiler.profile(activities=acts):    # the profiler's start-up
        torch.zeros(1, device=device).add_(1)
        sync()
    setup_s = time.perf_counter() - t_start
    profiled_s = 0.0
    for i in range(len(entries)):        # the profiled pass, the tracer off
        with torch.profiler.profile(activities=acts) as prof:
            c0 = time.perf_counter()
            call(i)
            sync()
            profiled_s += time.perf_counter() - c0
        del prof
    s0 = time.perf_counter()
    t = span_pass(session, [(e["name"], lambda i=i: call(i)) for i, e in enumerate(entries)],
                  sync, acts)
    if t is None:
        return None
    t.profiled_wall_s = profiled_s
    print_spans(t, time.perf_counter() - s0)
    return {"workload": workload, "seed": seed,
            "device": torch.cuda.get_device_name(0) if on_card else "cpu",
            "power_limit_w": run.power_limit_w() if on_card else None,
            "setup_s": setup_s, "profiled_pass_s": profiled_s, "span_pass_s": t.wall_s,
            "level_spans": t.level_spans, "idle_s": t.idle_ns / 1e9,
            "idle_under_loop": t.idle_share_under(lambda n: is_level(n) or n in LOOP),
            "answers_equal": all(a == ans[0] for ans in answers for a in ans),
            "metrics": metrics(t)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")    # as run.py: one host thread
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("the span pass wants a CUDA device; torch sees none", file=sys.stderr)
        return 2
    result = span_cell(args.workload, args.seed)
    if result is None:
        print("the program's tracer is not on the profiler's clock: no span pass",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
