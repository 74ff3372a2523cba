#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 bench/run.py --workload mico.cliques --seed 7 --seconds 30 --trace 0

One process runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout:

1. the cell's graph: its configuration's generator (``bench/graphs.py``,
   ``bench/generators/``; kept under ``build/bench/`` after a checkout's
   first run), its edge list in an order drawn from ``--seed``;
2. ``build_csr`` and one ``repro_torch.Miner`` with its default config;
3. one warm pass of the cell's traffic (``bench/traffic/<mix>.json``);
4. the window: whole passes, in the list's order, one client, each call
   ending in its count on the host, until ``--seconds`` have gone by;
   in a cell with an end-to-end metric from the device trace each call runs
   under ``torch.profiler`` (CUDA activity alone) and the window is the
   calls' wall (``--trace 1``: one pass without the profiler, then passes whose
   calls each run under ``torch.profiler``, for ``TRACE_SECONDS``, and the
   cell's per-layer metrics, each read by ``bench/metrics/<name>.py``);
5. the program's state freed, the plain reference (``bench/reference.py``)
   computes every count again from the same edge list on the card, and
   every answer of the warm pass and the window is compared with it;
6. the numbers compared, beside their limits, as the last lines of
   standard error, and one JSON line as the last line of standard output.

It exits non-zero and prints no result without a card, when the cell
wants more cards than are visible, or when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` were loaded in this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run (the JAX stack and
# the JAX package, compared whole: ``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds of passes a traced run profiles (whole passes, at least one)
TRACE_SECONDS = 3.0


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entries(traffic: dict) -> list[dict]:
    """The traffic's calls, each with its ``name`` and its ``queries``."""
    out = []
    for call in traffic["calls"]:
        queries = call["queries"] if call["op"] == "count_many" else [call["query"]]
        out.append({"op": call["op"], "queries": queries,
                    "name": f"{call['op']}:{'+'.join(queries)}"})
    return out


def _call(session, entry: dict):
    """One call of the traffic on the session: an int or a list of ints."""
    if entry["op"] == "count":
        return session.count(entry["queries"][0])
    if entry["op"] == "count_many":
        return session.count_many(entry["queries"])
    raise ValueError(f"unknown traffic op {entry['op']!r}")


def _counters(session) -> dict:
    """The session's counters as one flat dict of numbers."""
    stats = getattr(session, "stats", None) or {}
    out = {k: v for k, v in (stats.get("runner") or {}).items()
           if isinstance(v, (int, float))}
    if isinstance(stats.get("rebuilds"), (int, float)):
        out["rebuilds"] = stats["rebuilds"]
    metrics = getattr(session, "metrics", None)
    if metrics is not None:
        for k, v in metrics.snapshot().items():
            if isinstance(v, (int, float)) and k not in out:
                out[k] = v
    return out


def reader_path(name: str, metrics: Path = BENCH / "metrics") -> Path:
    """``metrics/<name>.py``; a metric split by the end-to-end metric it
    moves, ``<name>.<suffix>`` with no file of its own, reads with
    ``<name>``'s reader."""
    path = metrics / f"{name}.py"
    while not path.is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = metrics / f"{name}.py"
    return path


def _load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Window:
    """What a metric reader reads: the profiled passes of a traced run."""

    passes: int                     # whole passes profiled
    counters: dict                  # the session's counters over them
    plain_wall_s: float             # the pass before them, not profiled
    plain_counters: dict            # the session's counters over it
    trace: object                   # devtrace.DeviceTrace, None off the card
    peak_mem_bytes: int | None      # the card's peak over them
    device_name: str
    num_vertices: int
    directed_edges: int
    calls: list                     # answers of each call of a pass


def host_clock() -> dict:
    """What the host's clock can say of the machine: the CPU time stolen
    from this virtual machine by its host (``/proc/stat``'s steal, in
    seconds, since boot) and the mean clock of its cores (MHz); None for
    what this system does not show."""
    out = {"steal_s": None, "mhz": None}
    try:
        fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
        mhz = [float(line.split(":")[1]) for line in
               Path("/proc/cpuinfo").read_text().splitlines() if line.startswith("cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        pass
    return out


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi, None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", scale: float = 1.0, make_session=None,
             t_start: float | None = None) -> dict:
    """Run one cell once and return its result object (the last line).

    ``device`` and ``scale`` are the tests' (``cpu`` and a small twin);
    ``make_session(graph, edges, num_vertices)`` puts another session in the
    program's place (the control). The benchmark's own runs pass neither."""
    t_start = T_START if t_start is None else t_start
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import numpy as np
    import torch

    from bench import devtrace, graphs, reference

    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"{cell['traffic']}: the harness drives a closed loop of 1 client")
    entries = _entries(traffic)
    on_card = torch.device(device).type == "cuda"

    marks = [("start", t_start), ("imports", time.perf_counter())]
    edges, num_vertices = graphs.edges_of(
        config, scale, ROOT / "build" / "bench" if scale == 1.0 else None)
    edges = graphs.shuffle(edges, seed)

    from repro_torch.graph.csr import build_csr
    from repro_torch.mining.session import Miner

    marks.append(("graph", time.perf_counter()))
    graph = build_csr(edges, num_vertices=num_vertices, undirected=True)
    marks.append(("csr", time.perf_counter()))
    if make_session is not None:
        session = make_session(graph, edges, num_vertices)
    else:   # the default config on the card; the tests name the CPU
        session = Miner(graph) if on_card else Miner(graph, device=device)
    marks.append(("session", time.perf_counter()))
    answers: list[list] = [[] for _ in entries]

    def one_call(i: int) -> None:
        try:
            answers[i].append(_call(session, entries[i]))
        except Exception:       # a query that raised is a failed query
            traceback.print_exc()
            answers[i].append(None)

    def one_pass() -> None:
        for i in range(len(entries)):
            one_call(i)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    # a cell with an end-to-end metric read from the device trace has every
    # call of its untraced window profiled (CUDA activity alone)
    profiled = on_card and not trace and any(
        m["source"] == "device_trace" for m in spec["end_to_end"] if _applies(m, workload))
    act = torch.profiler.ProfilerActivity
    one_pass()                           # the warm pass: every shape of the mix
    sync()
    if profiled:                         # the profiler's own start-up, in set-up
        with torch.profiler.profile(activities=[act.CUDA]):
            torch.zeros(1, device=device).add_(1)
            sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = _counters(session)
    warm = len(answers[0])
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("warm pass", t0))
    print("setup: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    passes = 0
    if not trace:
        ru0, cpu0, ends = resource.getrusage(resource.RUSAGE_SELF), time.process_time(), []
        hc0 = host_clock()
        busy_ns, calls_s, t_reduce = 0, 0.0, 0.0
        while True:
            if profiled:
                # each call profiled on its own and reduced at once: the
                # window is the calls' wall, outside the profiler's stops
                for i in range(len(entries)):
                    with torch.profiler.profile(activities=[act.CUDA]) as prof:
                        c0 = time.perf_counter()
                        one_call(i)
                        sync()
                        calls_s += time.perf_counter() - c0
                    r0 = time.perf_counter()
                    busy_ns += devtrace.busy_ns(prof.profiler.kineto_results.events())
                    del prof
                    t_reduce += time.perf_counter() - r0
                ends.append(t0 + calls_s)
            else:
                one_pass()
                ends.append(time.perf_counter())
            passes += 1
            if ends[-1] - t0 >= seconds:
                break
        sync()
        elapsed = time.perf_counter() - t0
        window_s = ends[-1] - t0 if profiled else elapsed
        metrics_e2e = {"pass_s": window_s / passes, "setup_s": setup_s}
        if profiled:
            metrics_e2e["pass_busy_s"] = busy_ns / 1e9 / passes
        ru1, hc1 = resource.getrusage(resource.RUSAGE_SELF), host_clock()
        # where the window's time went, for the record: each pass's seconds,
        # the process's CPU seconds, its involuntary context switches, the
        # machine's stolen CPU seconds and its cores' clock at both ends
        steal = None if hc0["steal_s"] is None else hc1["steal_s"] - hc0["steal_s"]
        print(f"window: passes {[round(b - a, 4) for a, b in zip([t0] + ends, ends)]} "
              f"cpu_s {time.process_time() - cpu0:.3f} of {elapsed:.3f} "
              f"preempted {ru1.ru_nivcsw - ru0.ru_nivcsw} steal_s {steal} "
              f"mhz {hc0['mhz']} {hc1['mhz']}", file=sys.stderr)
        if profiled:
            print(f"window: calls {window_s:.3f} s, busy {busy_ns / 1e9:.4f} s, profiler "
                  f"stops and reduction {elapsed - window_s:.3f} s (reduction {t_reduce:.3f})",
                  file=sys.stderr)
    else:
        # one pass without the profiler: the engine's host cost as it is
        one_pass()
        sync()
        plain_wall_s = time.perf_counter() - t0
        mid = _counters(session)
        plain_counters = {k: mid[k] - before.get(k, 0) for k in mid}
        before = mid
        # then whole passes, each call profiled on its own and reduced at once
        acts = [act.CUDA] if on_card else [act.CPU]
        calls, window_s, n_events, reduce_s = [], 0.0, 0, 0.0
        p0 = time.perf_counter()
        while True:
            for i, entry in enumerate(entries):
                with torch.profiler.profile(activities=acts) as prof:
                    c0 = time.perf_counter()
                    one_call(i)
                    sync()
                    window_s += time.perf_counter() - c0
                r0 = time.perf_counter()
                events = prof.profiler.kineto_results.events()
                n_events += len(events)
                calls.append(devtrace.summarize(events, entry["name"]))
                del events, prof
                reduce_s += time.perf_counter() - r0
            passes += 1
            if time.perf_counter() - p0 >= min(seconds, TRACE_SECONDS):
                break
        dtrace = devtrace.merge(calls)
        print(f"trace: plain pass {plain_wall_s:.3f} s, {passes} profiled, calls "
              f"{window_s:.3f} s, {n_events} events reduced in {reduce_s:.3f} s, all "
              f"{time.perf_counter() - p0:.3f} s", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated() if on_card else None
    after = _counters(session)
    counters = {k: after[k] - before.get(k, 0) for k in after}
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"

    # the program's state goes before the reference runs on the card
    del session, graph
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    want = reference.counts(edges, num_vertices, device=device)
    print(f"reference: {time.perf_counter() - r0:.3f} s", file=sys.stderr)

    compared, failed = {}, 0
    for i, entry in enumerate(entries):
        exp = [want[q] for q in entry["queries"]]
        worst = 0
        for j, ans in enumerate(answers[i]):
            got = [ans] if entry["op"] == "count" else ans
            if got is None or any(a is None for a in got) or len(got) != len(exp):
                bad = True
                worst = max(worst, max(exp) + 1)   # no answer: off by all of it
            else:
                err = max(abs(int(a) - b) for a, b in zip(got, exp))
                bad = err > 0
                worst = max(worst, err)
            failed += bool(bad and j >= warm)
        compared[f"err.{entry['name']}"] = {"value": worst, "limit": 0}
    attempted = (len(answers[0]) - warm) * len(entries)
    correct = attempted > 0 and all(c["value"] <= c["limit"] for c in compared.values())

    cell_metrics = {}
    if not trace:
        for m in spec["end_to_end"]:     # off the card no device metric
            if _applies(m, workload) and m["name"] in metrics_e2e:
                cell_metrics[m["name"]] = {"value": metrics_e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": cell["chips"] if on_card else 0,
           "memory_peak_bytes": max(setup_peak, window_peak) if on_card else 0,
           "power_limit_w": power_limit_w() if on_card else None}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": cell_metrics, "device": dev}
    if trace:
        lo, hi = edges.min(axis=1), edges.max(axis=1)
        directed = 2 * int(np.unique((lo * num_vertices + hi)[lo != hi]).shape[0])
        win = Window(passes=passes, counters=counters,
                     plain_wall_s=plain_wall_s, plain_counters=plain_counters,
                     trace=dtrace if on_card else None, peak_mem_bytes=window_peak,
                     device_name=device_name, num_vertices=num_vertices,
                     directed_edges=directed,
                     calls=[len(e["queries"]) for e in entries])
        for m in spec["per_layer"]:
            if _applies(m, workload):
                value = _load_reader(m["name"])(win)
                if value is not None:
                    cell_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = dtrace.busy_ns / 1e9
        dev["window_s"] = dtrace.window_ns / 1e9
        result["breakdown"] = {"device_ops": dtrace.top_kernels(),
                               "idle_gaps": dtrace.top_idle()}
    result["compared"] = compared
    return result


def forbidden_modules() -> list[str]:
    """Top-level names of ``FORBIDDEN`` that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for the host-side tensor ops: load from one process
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)

    spec = load_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in the run: {loaded}", file=sys.stderr)
        return 3
    print(f"run: {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
