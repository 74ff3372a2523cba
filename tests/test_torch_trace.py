"""The port's span tracer (``repro_torch.obs``) on the CPU: spans on the
profiler's clock, the engine's ``host`` spans where the host uploads,
waits, slices and launches, the launch counter, no synchronize in a traced
dispatch, and the Chrome export on the profiler's clock.

The module imports neither JAX nor the JAX package.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import Miner
from repro_torch.graph import build_csr, edge_list, edge_weights, with_edge_values
from repro_torch.graph.generators import powerlaw_cluster
from repro_torch.kernels import build
from repro_torch.mining.engine import WaveRunner
from repro_torch.obs import NO_SPAN, Telemetry, Tracer, activate, active, chrome_trace
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# at chunk 16 the waves split into many chunks: every expand slices, but
# for its children that are count leaves read in place
EDGES = powerlaw_cluster(80, 4, seed=5)
HOST = ("launch", "sync", "slice", "upload")


def _graph():
    return build_csr(EDGES, num_vertices=80)


def _parents(roots: list) -> dict:
    """{id(span): its parent span} over the trees ``roots``."""
    out = {}

    def walk(sp):
        for c in sp.children:
            out[id(c)] = sp
            walk(c)
    for root in roots:
        walk(root)
    return out


def _is_level(sp) -> bool:
    return sp.cat == "level" and sp.name.startswith("L")


def _mix(m):
    """Counts whose leaves read in place, and embeddings (4-clique's emit
    level reads sliced chunks)."""
    return (m.count("4-clique"), m.count_many(["diamond", "4-cycle", "paw"]),
            m.embeddings("triangle"), m.embeddings("4-clique"))


def test_span_times_are_ns_and_self_time_excludes_children():
    tr = Tracer(enabled=True)
    with tr.span("outer", n=1):
        time.sleep(0.002)
        with tr.span("inner", cat="host"):
            time.sleep(0.002)
        with tr.span("open"):
            assert tr.finished == []            # the root is still open
    outer, = tr.finished
    inner, still = outer.children
    assert (outer.name, outer.cat, outer.attrs) == ("outer", "span", {"n": 1})
    assert (inner.cat, still.name) == ("host", "open")
    assert isinstance(outer.t0_ns, int) and outer.t1_ns >= still.t1_ns >= inner.t1_ns
    assert outer.seconds == pytest.approx((outer.t1_ns - outer.t0_ns) / 1e9)
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds - still.seconds)
    assert tr.level_seconds()["inner"] == pytest.approx(inner.seconds)
    assert [sp.name for sp in tr.spans()] == ["outer", "inner", "open"]
    assert tr.last("inner").t0_ns == inner.t0_ns
    tr.clear()
    assert tr.finished == [] and tr.spans() == []
    assert Tracer().span("x") is NO_SPAN and Tracer().finished == []


def test_offset_puts_a_span_around_a_record_function_event():
    """Under a CPU profile, a span shifted by the tracer's offset holds the
    ``record_function`` event it encloses, on the event's clock."""
    tr = Tracer(enabled=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "inner")
    sp = tr.last("outer")
    off = tr.clock_offset_ns
    assert sp.t0_ns + off < ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() < sp.t1_ns + off
    # the perf counter alone is another clock: seconds to days away
    assert abs(ev.start_ns() - sp.t0_ns) > 10**9


@pytest.mark.parametrize("device_compact", [True, False])
def test_host_spans_nest_under_their_level_or_feed(device_compact):
    """``sync`` under a level span (a meta, pack or emit read) or
    ``finalize`` (the partials); ``slice`` under an expand level;
    ``upload`` under ``execute`` (the feed's chunk one ahead, issued between
    ``feed`` spans) or, on the host path, under the level whose next wave it
    uploads. No ``host`` span has children; the counts are the untraced
    session's."""
    tel = Telemetry(enabled=True)
    m = Miner(_graph(), device="cpu", chunk=16, telemetry=tel,
              device_compact=device_compact)
    got = _mix(m)
    roots = tel.tracer.finished         # one read: one set of Span objects
    parent = _parents(roots)
    every = [sp for r in roots for sp in r.walk()]
    by_name = {name: [sp for sp in every if sp.name == name] for name in HOST}
    assert by_name["sync"] and by_name["upload"] and not by_name["launch"]
    assert bool(by_name["slice"]) is device_compact
    for sp in by_name["sync"]:
        p = parent[id(sp)]
        assert _is_level(p) or p.name == "finalize"
    assert any(parent[id(sp)].name == "finalize" for sp in by_name["sync"])
    for sp in by_name["slice"]:
        assert _is_level(parent[id(sp)]) and parent[id(sp)].name.endswith(":expand")
    feed = [sp for sp in by_name["upload"] if parent[id(sp)].name == "execute"]
    assert feed and len(feed) == sum(sp.name == "feed" for sp in every)
    for sp in by_name["upload"]:
        p = parent[id(sp)]
        assert p.name == "execute" or (not device_compact and _is_level(p))
    assert all(not sp.children for name in HOST for sp in by_name[name])
    plain = Miner(_graph(), device="cpu", chunk=16, device_compact=device_compact)
    want = _mix(plain)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert len(got[3])
    assert dict(plain.runner.stats) == dict(m.runner.stats)


def test_aggregate_partials_read_in_a_sync_span():
    g = _graph()
    g = with_edge_values(g, edge_weights(edge_list(g), seed=3))
    tel = Telemetry(enabled=True)
    m = Miner(g, device="cpu", chunk=16, telemetry=tel)
    m.aggregate("triangle", "sum")
    fin = tel.tracer.last("finalize")
    assert [c.name for c in fin.children] == ["sync"]


def test_traced_dispatch_never_synchronizes(monkeypatch):
    """A traced level call neither calls the runner's old synchronize hook
    nor ``torch.cuda.synchronize``."""
    def boom(*a, **k):
        raise AssertionError("a traced dispatch synchronized")
    monkeypatch.setattr(WaveRunner, "_sync", boom, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    tel = Telemetry(enabled=True)
    m = Miner(_graph(), device="cpu", chunk=16, telemetry=tel)
    _mix(m)
    assert len(tel.tracer.spans("dispatch")) > 10


def _stub_launch(monkeypatch, calls: list):
    """``build.launch`` with a Python function for its ctypes entry point and
    device 0 current, so its counting and spanning run on the CPU."""
    def fn(*args):
        calls.append(args)
        return 0
    monkeypatch.setitem(build._FUNCTIONS, ("stub", "repro_stub"), fn)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1234,
                        raising=False)


@pytest.mark.parametrize("traced", [False, True])
def test_launch_counts_a_stubbed_launch(monkeypatch, traced):
    """Inside a session's query each launch counts in its telemetry's
    ``kernel_launches{symbol=...}``; traced it sits in a ``launch`` span
    (category ``host``, attribute ``symbol``); outside a query nothing
    counts."""
    calls: list = []
    _stub_launch(monkeypatch, calls)
    dev = torch.device("cuda", 0)
    t = torch.zeros(4, dtype=torch.int32)
    build.launch("stub", "repro_stub", dev, (t, None), (7,))   # no session
    tel = Telemetry(enabled=traced)
    assert active() is None
    with activate(tel):
        assert active() is tel
        with tel.tracer.span("dispatch", cat="dispatch"):
            for _ in range(3):
                build.launch("stub", "repro_stub", dev, (t, None), (7,))
    assert active() is None
    assert calls == [(t.data_ptr(), None, 7, 1234)] * 4
    fam = tel.metrics.series("kernel_launches")
    assert {k: c.value for k, c in fam.items()} == {(("symbol", "repro_stub"),): 3}
    spans = tel.tracer.spans("launch")
    assert len(spans) == (3 if traced else 0)
    assert all(sp.cat == "host" and sp.attrs == {"symbol": "repro_stub"} for sp in spans)
    if traced:
        assert [(c.name, c.t0_ns) for c in tel.tracer.last("dispatch").children] == \
            [(sp.name, sp.t0_ns) for sp in spans]


def test_in_place_leaf_dispatch_has_no_slice_before_it():
    """4-clique's carried leaf and paw's general leaf read their parent's
    worklist in place: each dispatch span says ``inplace=True`` and its
    form (``carried``, ``csr``), and no ``slice`` span sits under the
    expand before its level span; with ``fused_level=False`` paw's leaf
    reads sliced chunks, each level span right after its ``slice``."""
    tel = Telemetry(enabled=True)
    m = Miner(_graph(), device="cpu", chunk=16, telemetry=tel)
    m.count("4-clique")
    m.count("paw")
    Miner(_graph(), device="cpu", chunk=16, telemetry=tel, fused_level=False).count("paw")
    roots = tel.tracer.finished
    parents = _parents(roots)
    assert len(roots) == 3
    for root, form in zip(roots, ("carried", "csr", None)):
        in_place = form is not None
        leaves = []

        def walk(sp):
            leaves.extend(c for c in sp.children if c.name == "L3:count")
            for c in sp.children:
                walk(c)
        walk(root)
        assert len(leaves) > 1
        for leaf in leaves:
            disp, = [c for c in leaf.children if c.name == "dispatch"]
            assert disp.attrs.get("inplace", False) is in_place
            assert disp.attrs.get("form") == form
            sibs = parents[id(leaf)].children
            at = next(i for i, c in enumerate(sibs) if c is leaf)
            assert (sibs[at - 1].name == "slice") is not in_place
            assert any(c.name == "slice" for c in sibs[:at]) is not in_place


def test_activate_nests_and_restores():
    a, b = Telemetry(), Telemetry()
    with activate(a):
        with activate(b):
            assert active() is b
        assert active() is a
    assert active() is None


def test_run_activates_the_session_telemetry(monkeypatch):
    """A level call runs with its session's telemetry active; none is
    active before or after the query."""
    seen = []
    dispatch = WaveRunner._dispatch

    def spy(self, *a, **k):
        seen.append(active())
        return dispatch(self, *a, **k)
    monkeypatch.setattr(WaveRunner, "_dispatch", spy)
    m = Miner(_graph(), device="cpu")
    assert active() is None
    m.count_many(["triangle", "4-clique"])
    assert active() is None
    assert seen and all(t is m.telemetry for t in seen)


def test_upload_counts_no_bytes_off_the_card():
    m = Miner(_graph(), device="cpu")
    m.count("4-clique")
    assert m.metrics.value("feed_h2d_bytes") == 0
    assert m.metrics.series("kernel_launches") == {}


def test_chrome_trace_ts_on_the_profiler_clock(tmp_path):
    tel = Telemetry(enabled=True)
    m = Miner(_graph(), device="cpu", telemetry=tel)
    m.count("triangle")
    q = tel.tracer.last("query")
    base = 1_700_000_000 * 10**9
    doc = chrome_trace(tel.tracer, base_ns=base)
    ev = doc["traceEvents"][0]
    assert ev["name"] == "query" and doc["baseTimeNanoseconds"] == base
    assert ev["ts"] == pytest.approx((q.t0_ns + tel.tracer.clock_offset_ns - base) / 1e3)
    # on the epoch's clock: within a minute of now
    assert abs(ev["ts"] * 1e3 + base - time.time_ns()) < 60e9
    path = tel.write_trace(tmp_path / "t.json", base_ns=base)
    written = json.loads(path.read_text())
    assert written["traceEvents"] == doc["traceEvents"]
    assert "metrics" in written["otherData"]
