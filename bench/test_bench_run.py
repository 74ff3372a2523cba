"""The harness driven on the CPU at small scale (its look for a card
skipped): a sound run comes out correct, and a run with the timed path
broken underneath, or with the control in the program's place, does not."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench import control, run
from repro_torch.mining import engine

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"mico.cliques": 0.003, "mico.motifs": 0.003}


def run_small(workload, trace=False, **kw):
    return run.run_cell(run.load_spec(), workload, 2**31 + 99, 0.01, trace, device="cpu",
                        scale=SMALL[workload], t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    r = run_small(workload, trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "compared"
    assert all(c == {"value": 0, "limit": 0} for c in r["compared"].values())
    spec = run.load_spec()
    if trace:
        want = {m["name"] for m in spec["per_layer"] if workload in m["workloads"]}
        # off the card the device's readers find nothing to read
        device = {"device.idle_pct", "device.peak_mem_gib", "kernels.device_ms",
                  "kernels.pass_roofline"}
        assert set(r["metrics"]) == {m for m in want if run.reader_path(m).stem not in device}
        rebuilds = next(m for m in r["metrics"] if m.startswith("session.rebuilds"))
        assert r["metrics"][rebuilds]["value"] == 0
    else:
        # off the card no end-to-end metric read from the device trace
        assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                     if run._applies(m, workload)
                                     and m["source"] == "host_clock"}
        assert "setup_s" in r["metrics"]


def half_the_feed(monkeypatch):
    """Half of each feed chunk's edges left out: its later rows count as
    padding (bound 0)."""
    feed = engine.WaveRunner._edge_feed

    def half_of_each_chunk(self, symmetric):
        for cap, dv0, dv1, v1h, n in feed(self, symmetric):
            yield cap, dv0, dv1, v1h, n // 2
    monkeypatch.setattr(engine.WaveRunner, "_edge_feed", half_of_each_chunk)


def answer_altered(monkeypatch):
    """Every count one off where the engine reduces it."""
    finalize = engine.WaveRunner._finalize
    monkeypatch.setattr(engine.WaveRunner, "_finalize",
                        lambda self, plan, parts: finalize(self, plan, parts) + 1)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", [half_the_feed, answer_altered])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    r = run_small(workload)
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert max(c["value"] for c in r["compared"].values()) > 0


def test_a_query_that_raises_fails(monkeypatch):
    def boom(self, plan):
        raise RuntimeError("planted")
    monkeypatch.setattr(engine.WaveRunner, "run", boom)
    r = run_small("mico.cliques")
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    """The control (sampled estimates in the program's place) fails the
    comparison: exact counts are the configurations' guarantee."""
    r = run_small(workload, make_session=control.factory(2**31 + 99, "cpu"))
    assert not r["correct"]
    assert max(c["value"] for c in r["compared"].values()) > 0


def test_without_a_card_no_result():
    """Here torch sees no card: the command exits non-zero, prints no result."""
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "mico.cliques",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    """End to end on the card: one short run of the smallest cell."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "mico.cliques",
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


def test_host_clock_reads_steal_and_clock():
    """The window's record of the machine: stolen CPU seconds since boot and
    the cores' mean clock, or None where the system does not show them."""
    hc = run.host_clock()
    assert set(hc) == {"steal_s", "mhz"}
    assert hc["steal_s"] is None or hc["steal_s"] >= 0
    assert hc["mhz"] is None or hc["mhz"] > 0
