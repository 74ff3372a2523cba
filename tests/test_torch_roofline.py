"""The port's roofline (``repro_torch.roofline``) against the JAX package's:
the report's arithmetic on the same inputs, and what ``CostCounter`` counts
on a fake world (in a subprocess: a ``fake`` process group of 8 ranks) —
the collective bytes of known redistributions, a sharded matmul's local
FLOPs, a pure data-parallel step's FLOPs against one device's at batch/8,
and FLOPs growing linearly in units (the property the JAX dry run's scan
calibration rebuilds, since XLA counts a scan body once)."""
import json
import os
import subprocess
import sys

import pytest

from repro.roofline import analysis as JR
from repro_torch.roofline.analysis import (H100, HW, collective_bytes, model_flops_6nd,
                                           roofline_report)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_h100_constants():
    assert (H100.flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes) == \
        (989.4e12, 3.35e12, 450e9, 80e9)
    assert [f.name for f in JR.HW.__dataclass_fields__.values()] == \
        [f.name for f in HW.__dataclass_fields__.values()]


@pytest.mark.parametrize("case", [
    dict(flops=197e12, bytes_hbm=819e9 / 2, coll={"all-reduce": 50e9 / 4}, chips=256,
         model_flops=197e12 * 256 / 2),
    dict(flops=3.1e15, bytes_hbm=7.7e11, coll={"all-gather": 2.5e10, "all-reduce": 1e9},
         chips=512, model_flops=9.9e17, per_device=False),
    dict(flops=0.0, bytes_hbm=0.0, coll={}, chips=1),
])
def test_roofline_report_equals_jax(case):
    """The same report as the JAX function, given the same ``hw`` values
    (the H100's in both)."""
    jhw = JR.HW(flops=H100.flops, hbm_bw=H100.hbm_bw, ici_bw=H100.ici_bw,
                hbm_bytes=H100.hbm_bytes)
    assert roofline_report(**case) == JR.roofline_report(**case, hw=jhw)


def test_roofline_report_math():
    hw = HW(flops=197e12, hbm_bw=819e9, ici_bw=50e9, hbm_bytes=16e9)
    r = roofline_report(flops=197e12, bytes_hbm=819e9 / 2, coll={"all-reduce": 50e9 / 4},
                        chips=256, hw=hw, model_flops=197e12 * 256 / 2)
    assert abs(r["compute_s"] - 1.0) < 1e-6
    assert abs(r["memory_s"] - 0.5) < 1e-6
    assert abs(r["collective_s"] - 0.25) < 1e-6
    assert r["dominant"] == "compute_s"
    assert abs(r["roofline_fraction"] - 1.0) < 1e-6
    assert abs(r["useful_flops_ratio"] - 0.5) < 1e-6


@pytest.mark.parametrize("args", [(10, 5), (10, 5, 2), (596049920, 2048 * 4096, None)])
def test_model_flops_equals_jax(args):
    assert model_flops_6nd(*args) == JR.model_flops_6nd(*args)


def test_collective_bytes_keys():
    recs = [("all_reduce", 4096), ("all_gather_into_tensor", 1024), ("all_reduce", 4),
            ("reduce_scatter_tensor", 256), ("all_to_all_single", 64), ("broadcast", 8),
            ("wait_tensor", 99)]
    assert collective_bytes(recs) == {"all-reduce": 4100, "all-gather": 1024,
                                      "reduce-scatter": 256, "all-to-all": 64,
                                      "collective-permute": 8}


SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor, DTensor
from repro_torch.launch.dryrun import fake_world, _fake_model
from repro_torch.launch.mesh import device_mesh
from repro_torch.roofline.analysis import CostCounter, collective_bytes
from repro_torch.configs import get_arch
from repro_torch.train.train_step import ShardedTrainStep, TrainStep
from repro_torch.train.optimizer import adamw_init

out = {}
fake_world(8)
mesh = device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
R = Replicate()
with FakeTensorMode(allow_non_fake_inputs=True):
    # a tensor sharded over 'model' gathered whole; a partial sum over 'data'
    x = distribute_tensor(torch.zeros(8, 16), mesh, [R, R, Shard(0)], src_data_rank=None)
    with CostCounter() as c:
        x.redistribute(mesh, [R, R, R])
    out["gather"] = collective_bytes(c.records)
    p = DTensor.from_local(torch.zeros(8, 16), mesh, [R, Partial(), R])
    with CostCounter() as c:
        p.redistribute(mesh, [R, R, R])
    out["reduce"] = collective_bytes(c.records)
    # [256,1024] @ [1024,4096]: rows over (pod, data), columns over model
    a = distribute_tensor(torch.zeros(256, 1024), mesh, [Shard(0), Shard(0), R],
                          src_data_rank=None)
    b = distribute_tensor(torch.zeros(1024, 4096), mesh, [R, R, Shard(1)], src_data_rank=None)
    with CostCounter() as c:
        y = a @ b
    out["matmul"] = [c.flops, list(y.to_local().shape)]

dist.destroy_process_group()
fake_world(8)
spec = get_arch("qwen3-0.6b")
cfg = spec.smoke_config


def batch(B, S=32):
    return {"tokens": torch.zeros(B, S, dtype=torch.int32),
            "targets": torch.zeros(B, S, dtype=torch.int32)}


def one_device(cfg, B):
    model = _fake_model(cfg, "cpu")
    step = TrainStep(model)
    with CostCounter() as c:
        step(adamw_init(model.tree(), step.opt_cfg), batch(B), 0)
    return c.flops


dp = device_mesh((8, 1), ("data", "model"), "cpu")
with FakeTensorMode(allow_non_fake_inputs=True):
    model = _fake_model(cfg, "cpu")
    step = ShardedTrainStep(model, dp)
    opt = step.init_state()
    with CostCounter() as c:
        step(opt, batch(8), 0)
    out["dp8"] = [c.flops, one_device(cfg, 1), dict(collective_bytes(c.records))]
    out["units"] = [one_device(dataclasses.replace(cfg, num_layers=n), 2) for n in (2, 4, 6)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world_counts():
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_collective_bytes_of_known_redistributions(fake_world_counts):
    # an (8, 16) float32 tensor: the gathered result and the reduced one, 512 bytes each
    assert fake_world_counts["gather"] == {"all-gather": 8 * 16 * 4}
    assert fake_world_counts["reduce"] == {"all-reduce": 8 * 16 * 4}


def test_sharded_matmul_counts_local_flops(fake_world_counts):
    flops, shape = fake_world_counts["matmul"]
    assert shape == [64, 2048]
    assert flops == 2 * 64 * 1024 * 2048


def test_pure_dp_step_counts_one_device_flops_at_batch_over_8(fake_world_counts):
    """On (8, 1) every parameter is whole on every rank (DEFAULT_RULES shard
    nothing over 'data'): the step's collectives are the sums over 'data'."""
    sharded, single, coll = fake_world_counts["dp8"]
    assert sharded == single > 0
    assert set(coll) == {"all-reduce"}


def test_flops_grow_linearly_in_units(fake_world_counts):
    """Every unit is dispatched and counted (the counterpart of
    test_roofline.py's scan_body_counted_once, whose effect the JAX dry run
    calibrates away)."""
    f2, f4, f6 = fake_world_counts["units"]
    assert f2 < f4 < f6
    assert f6 - f4 == f4 - f2
