"""BENCHMARK.json against the benchmark's contract: keys, names, files,
bounds, the run length's budget, and a reader for every per-layer metric."""
import json
import re
from pathlib import Path

import pytest

from bench import run

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60,
    # 24 x 180 s to compile, 1200 s spare, in 43200 s
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and 1 <= len(cfg["source"]) <= 200
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"].startswith("bench/configs/")
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert data["guarantees"]["counts"].startswith("exact")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    assert (ROOT / "bench" / "traffic" / f"{cell['traffic']}.json").is_file()
    def reported(group):
        return [m for m in SPEC[group] if "workloads" not in m or cell["name"] in m["workloads"]]
    e2e = {m["name"] for m in reported("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    # each per-layer metric of the cell moves an end-to-end metric it reports
    assert reported("per_layer") and all(m["moves"] in e2e for m in reported("per_layer"))


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert run.reader_path(m["name"]).is_file()
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
