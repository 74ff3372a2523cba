"""The span pass (``bench/spans.py``): its reduction on small recorded
span trees and profiles, its metrics, and the pass itself driven on the CPU
at small scale."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import control, graphs, spans

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"mico.cliques": 0.003, "mico.motifs": 0.003}


class Ev:
    """A stand-in for a kineto event of ``prof.profiler.kineto_results``."""

    def __init__(self, name, start, dur, cuda=False, thread=1):
        from torch.autograd import DeviceType
        self._v = (name, start, dur, DeviceType.CUDA if cuda else DeviceType.CPU, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return False

    def start_thread_id(self):
        return self._v[4]


class Sp:
    """A stand-in for a finished ``repro_torch.obs.Span`` (perf-counter ns)."""

    def __init__(self, name, t0, t1, *children):
        self.name, self.t0_ns, self.t1_ns, self.children = name, t0, t1, list(children)


# one span-pass call, its spans on the perf counter 1000 ns behind the
# profiler's clock: a query whose feed chunk runs an expand level (a
# dispatch with one launch, the meta sync, a slice) and a count level
ROOTS = [Sp("query", 0, 1000,
            Sp("execute", 50, 950,
               Sp("feed", 100, 900,
                  Sp("L2:expand", 100, 850,
                     Sp("dispatch", 100, 300, Sp("launch", 150, 200)),
                     Sp("sync", 300, 500), Sp("slice", 500, 600),
                     Sp("L3:count", 600, 800, Sp("dispatch", 620, 780))))))]
# the device busy 1100-1300, 1600-1700 and 2300-2400; the calling thread's
# runtime launch 1080-1100; the profiler's own thread outside the call
SPAN_EVENTS = [Ev("cudaLaunchKernel", 1080, 20), Ev("k", 1100, 200, cuda=True),
               Ev("k", 1600, 100, cuda=True), Ev("k", 2300, 100, cuda=True),
               Ev("Buffer Flush", 5000, 100, thread=2)]
SPAN_CALL = spans.reduce_call(SPAN_EVENTS, ROOTS, 1000, "count:5-clique", launches=1,
                              h2d_bytes=3 * 2**20)


def test_reduce_call_names_each_gap_by_its_innermost_span():
    """Gaps 1000-1100 (mid 1050: execute), 1300-1600 (mid 1450: the level's
    sync) and 1700-2300 (mid 2000: after the query's end, unspanned)."""
    t = SPAN_CALL
    assert t.idle_by_span == {"count:5-clique > execute": 100,
                              "count:5-clique > sync": 300,
                              "count:5-clique > unspanned": 600}
    assert t.idle_ns == 1000 and t.level_spans == 2
    assert t.spans["dispatch"] == [2, 360, 310] and t.spans["launch"] == [1, 50, 50]
    assert t.spans["L2:expand"] == [1, 750, 50] and t.spans["L3:count"] == [1, 200, 40]
    assert t.spans["feed"] == [1, 800, 50] and t.spans["query"] == [1, 1000, 100]
    assert t.total(spans.is_level) == (2, 950, 90)
    assert t.idle_share_under(lambda n: spans.is_level(n) or n in spans.LOOP) == 0.3
    assert t.top_idle(1) == [["count:5-clique > unspanned", 6e-7]]


def test_reduce_call_off_the_card_names_no_gap():
    cpu = [Ev("aten::nonzero", 50, 500), Ev("aten::cumsum", 1400, 500)]
    t = spans.reduce_call(cpu, ROOTS, 1000, "count:triangle")
    assert t.idle_by_span == {} and t.idle_ns == 0 and t.level_spans == 2


def test_span_merge_adds_the_calls_up():
    a = dataclasses.replace(SPAN_CALL, wall_s=0.5)
    m = spans.merge([a, a])
    assert m.spans["dispatch"] == [4, 720, 620] and m.idle_ns == 2000
    assert m.idle_by_span["count:5-clique > sync"] == 600
    assert (m.launches, m.h2d_bytes, m.wall_s) == (2, 6 * 2**20, 1.0)
    assert SPAN_CALL.spans["dispatch"] == [2, 360, 310]     # the parts unchanged


def test_innermost_span():
    assert spans._innermost(ROOTS, 150) == "launch"
    assert spans._innermost(ROOTS, 700) == "dispatch"
    assert spans._innermost(ROOTS, 790) == "L3:count"
    assert spans._innermost(ROOTS, 1000) == spans.UNSPANNED
    assert spans._innermost([], 5) == spans.UNSPANNED
    assert [spans.is_level(n) for n in ("L2:expand", "L12:count", "Lx:y", "feed")] == \
        [True, True, False, False]


# the recorded call's metrics: 2 level spans, 1 launch, 3 MiB uploaded
READINGS = {
    "engine.self_us": 90 / 1e3 / 2,
    "engine.ops_us": (310 + 100) / 1e3 / 2,
    "engine.sync_us": 200 / 1e3 / 2,
    "kernels.launch_us": 50 / 1e3,
    "kernels.launches": 1,
    "feed.h2d_mib": 3.0,
}


@pytest.mark.parametrize("name", spans.METRICS)
def test_metric_on_a_recorded_call(name):
    assert spans.metrics(SPAN_CALL)[name] == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", ["kernels.launch_us", "kernels.launches", "feed.h2d_mib"])
def test_launch_and_upload_metrics_read_nothing_without_them(name):
    """Off the card the span pass launches nothing and uploads nothing to a
    card: those metrics read None, never 0; the span metrics read on."""
    got = spans.metrics(dataclasses.replace(SPAN_CALL, launches=0, h2d_bytes=0))
    assert got[name] is None and got["engine.sync_us"] == pytest.approx(0.1)


def test_metrics_read_nothing_without_a_level_span():
    empty = spans.merge([])
    assert spans.metrics(empty) == dict.fromkeys(spans.METRICS)


class _Tracer:
    """A tracer of a program before the profiler's clock: no offset."""

    enabled = False


@pytest.mark.parametrize("session", [object(), type("S", (), {"telemetry": None})(),
                                     type("S", (), {"telemetry": type(
                                         "T", (), {"tracer": _Tracer()})()})()])
def test_no_span_pass_without_a_tracer_on_the_profiler_clock(session):
    """A session without telemetry and a program whose tracer has no clock
    offset run no span pass: nothing is called."""
    called = []
    assert spans.span_pass(session, [("q", lambda: called.append(1))], lambda: None,
                           []) is None
    assert called == []


def test_control_runs_no_span_pass():
    """The control (sampled estimates in the program's place) has no tracer."""
    config = json.loads((ROOT / "bench" / "configs" / "mico.json").read_text())
    edges, n = graphs.edges_of(config, SMALL["mico.motifs"], None)
    session = control.factory(2**31 + 99, "cpu")(None, edges, n)
    called = []
    assert spans.span_pass(session, [("count:paw", lambda: called.append(1))],
                           lambda: None, []) is None
    assert called == []


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_span_pass_of_a_small_cell(workload):
    """On the CPU: every pass gives the same answers, the engine's spans read
    above 0, and nothing is launched on or uploaded to a card."""
    r = spans.span_cell(workload, 2**31 + 99, device="cpu", scale=SMALL[workload])
    assert r["answers_equal"] and r["level_spans"] > 0 and r["device"] == "cpu"
    m = r["metrics"]
    assert all(m[k] > 0 for k in ("engine.self_us", "engine.ops_us"))
    assert m["engine.sync_us"] >= 0
    assert m["kernels.launches"] is None and m["feed.h2d_mib"] is None
    assert r["idle_s"] == 0 and r["span_pass_s"] > 0 and r["profiled_pass_s"] > 0


def test_without_a_card_no_result():
    """Here torch sees no card: the command exits 2 and prints no result."""
    out = subprocess.run([sys.executable, "bench/spans.py", "--workload", "mico.cliques",
                          "--seed", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_span_pass_on_the_card():
    """The span pass of the smallest cell on the card: each call's idle time
    named, launches and uploads counted, the same answers as untraced."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    r = spans.span_cell("mico.motifs", 2**31 + 3, scale=SMALL["mico.motifs"])
    assert r["answers_equal"] and r["idle_s"] > 0 and r["idle_under_loop"] > 0.5
    assert r["metrics"]["kernels.launches"] > 0 and r["metrics"]["feed.h2d_mib"] > 0
