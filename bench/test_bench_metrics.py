"""The metric readers, the trace reduction and the roofline's byte count on
small recorded profiles and counter snapshots."""
import json
from pathlib import Path

import pytest

from bench import devtrace, roofline, run

BENCH = Path(__file__).resolve().parent


class Ev:
    """A stand-in for a kineto event of ``prof.profiler.kineto_results``."""

    def __init__(self, name, start, dur, cuda=False, annotation=False, thread=1):
        from torch.autograd import DeviceType
        self._v = (name, start, dur, DeviceType.CUDA if cuda else DeviceType.CPU,
                   annotation, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


# one profiled call: on its thread an aten op, a sync and another aten op
# (50-1900 ns); kernels 100-300 and 1200-1300, a copy 250-400 (it overlaps
# the first kernel), a CUDA-side annotation that is no activity, and an event
# of the profiler's own thread, outside the call
EVENTS = [
    Ev("aten::nonzero", 50, 500),
    Ev("cudaStreamSynchronize", 600, 300),
    Ev("aten::cumsum", 1400, 500),
    Ev("kern_a", 100, 200, cuda=True),
    Ev("Memcpy DtoH (Device -> Pinned)", 250, 150, cuda=True),
    Ev("kern_b", 1200, 100, cuda=True),
    Ev("annotation", 0, 2000, cuda=True, annotation=True),
    Ev("Buffer Flush", 2500, 100, thread=2),
]


def test_summarize_recorded_profile():
    t = devtrace.summarize(EVENTS, "count:triangle")
    assert t.window_ns == 1850                      # 50-1900
    assert t.busy_ns == 400                         # 100-400, 1200-1300
    assert t.kernel_ns == {"kern_a": 200, "kern_b": 100}
    assert t.idle_by_host == {
        "count:triangle > aten::nonzero": 50,             # 50-100
        "count:triangle > cudaStreamSynchronize": 800,    # 400-1200
        "count:triangle > aten::cumsum": 600,             # 1300-1900
    }
    assert t.top_kernels(1) == [["kern_a", 2e-7]]
    assert t.top_idle()[0] == ["count:triangle > cudaStreamSynchronize", 8e-7]


def test_busy_ns_reads_the_device_alone():
    """The untraced window's reduction: the same busy time as summarize's."""
    assert devtrace.busy_ns(EVENTS) == devtrace.summarize(EVENTS, "q").busy_ns == 400
    assert devtrace.busy_ns(EVENTS[:3]) == 0


def test_merge_adds_the_calls_up():
    a = devtrace.summarize(EVENTS, "count:triangle")
    b = devtrace.summarize(EVENTS[3:6], "count:paw")     # the device alone: no gap
    m = devtrace.merge([a, a, b])
    assert m.window_ns == 2 * 1850 + 1200 and m.busy_ns == 2 * 400 + 400
    assert m.kernel_ns == {"kern_a": 600, "kern_b": 300}
    assert m.idle_by_host["count:triangle > aten::cumsum"] == 1200
    assert m.idle_by_host["count:paw > python"] == 800


def test_summarize_needs_an_event():
    with pytest.raises(ValueError):
        devtrace.summarize([], "count:triangle")


def test_gaps_and_union():
    assert devtrace.union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3), (5, 10)]
    assert devtrace.gaps([(0, 3), (5, 10)], 0, 12) == [(3, 5), (10, 12)]
    assert devtrace.gaps([], 0, 4) == [(0, 4)]
    assert devtrace.name_gaps([(10, 20)], [], "q") == {"q > python": 10}


def test_pass_bytes_counts_the_csr_once_a_call():
    # mico: 96638 vertices, 1080286 edges held both ways
    one = 4 * 96639 + 4 * 2160572
    assert roofline.csr_bytes(96638, 2160572) == one == 9028844
    assert roofline.pass_bytes(96638, 2160572, [1, 1, 1]) == 3 * one + 24
    assert roofline.pass_bytes(96638, 2160572, [1, 1, 2, 1, 1]) == 5 * one + 48
    assert roofline.least_seconds(96638, 2160572, [1], "NVIDIA H100 80GB HBM3") == \
        pytest.approx((one + 8) / 3.35e12)
    assert roofline.least_seconds(96638, 2160572, [1], "cpu") is None


def window(**kw):
    base = dict(passes=2, counters={"level_kernel_dispatches": 4000,
                                                 "feed_chunks": 1354, "items": 10,
                                                 "rebuilds": 0},
                plain_wall_s=0.75, plain_counters={"level_kernel_dispatches": 2500},
                trace=devtrace.summarize(EVENTS, "count:triangle"), peak_mem_bytes=3 * 2**29,
                device_name="NVIDIA H100 80GB HBM3", num_vertices=96638,
                directed_edges=2160572, calls=[1, 1, 1])
    base.update(kw)
    return run.Window(**base)


READINGS = {
    "device.idle_pct": 100.0 * (1 - 400 / 1850),
    "device.peak_mem_gib": 1.5,
    "kernels.device_ms": 150e-6,
    "kernels.pass_roofline": 100.0 * (3 * 9028844 + 24) / 3.35e12 / 150e-9,
    "engine.level_calls": 2000.0,
    "engine.call_us": 300.0,     # the pass without the profiler
    "feed.chunks": 677.0,
    "compaction.items": 5.0,
    "session.rebuilds": 0,
    "session.pass_s": 0.75,      # the pass without the profiler
}


def per_layer_names():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    return [m["name"] for m in spec["per_layer"]]


@pytest.mark.parametrize("name", per_layer_names())
def test_reader_on_recorded_window(name):
    """Each metric reads as its reader's file says; a split one (``.busy``)
    with its parent's reader."""
    assert run._load_reader(name)(window()) == pytest.approx(
        READINGS[run.reader_path(name).stem])


@pytest.mark.parametrize("name", sorted(set(READINGS) - {"session.rebuilds",
                                                         "compaction.items"}))
def test_reader_finds_nothing_off_the_card(name):
    """Off the card (no device trace, no peak, no counters) a reader returns
    nothing, never 0 for a share or a time."""
    assert run._load_reader(name)(window(trace=None, peak_mem_bytes=None,
                                         counters={}, plain_counters={})) is None


def test_reader_path_of_a_split_metric():
    metrics = BENCH / "metrics"
    assert run.reader_path("kernels.device_ms.busy") == metrics / "kernels.device_ms.py"
    assert run.reader_path("session.pass_s") == metrics / "session.pass_s.py"
    assert not run.reader_path("no.such_metric").is_file()


def test_call_us_reads_the_pass_without_the_profiler():
    """The profiled passes' counters do not enter it."""
    w = window(counters={"level_kernel_dispatches": 1})
    assert run._load_reader("engine.call_us")(w) == pytest.approx(300.0)
