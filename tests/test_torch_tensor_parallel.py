"""Tensor parallelism of the port's sharded train step
(``sharding.TensorParallel``: heads, d_ff, experts and vocabulary split
over 'model') against its one-device step. One ``torchrun --standalone`` of
4 gloo CPU ranks trains on the (1, 4) ('data', 'model') mesh that
``launch.train --model-parallel 4`` makes: every architecture's smoke config,
where each split dimension splits 4 ways and the 2 kv heads of most do not
(each rank reads its query heads' kv heads); qwen3-0.6b with 2 kv heads
unrepeated (a rank's one query head reads one of them) and with 24 query
heads over 3 kv heads (a rank's 6 read one each, 8 a kv head); and
deepseek-v2-lite-16b with each MoE dispatch, and with 6 experts (they do
not split 4 ways, so each expert's d_ff does) and a shared d_ff of 90 (whole
on every rank, added once). Float32, 3 steps; rank 0's loss and gnorm must
equal the one-device run's within rtol 1e-5, and every run must have gone
through split blocks."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_rows import one_torch_thread  # noqa: F401

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.launch.train import train_loop, zero_extras
from repro_torch.models.transformer import Model
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
STEPS, BATCH, SEQ = 3, 4, 16
DEEPSEEK = "deepseek-v2-lite-16b"
# name: (arch, config overrides, MoE config overrides)
RUNS = {a: (a, {}, {}) for a in ARCH_NAMES}
RUNS.update({
    "kv-2-unrepeated": ("qwen3-0.6b", {"kv_repeat": 1}, {}),
    "heads-24-kv-3": ("qwen3-0.6b", {"num_heads": 24, "num_kv_heads": 3, "kv_repeat": 1}, {}),
    "moe-einsum": (DEEPSEEK, {}, {"dispatch": "einsum"}),
    "moe-gsort": (DEEPSEEK, {}, {"dispatch": "gsort"}),
    "moe-6-experts-shared-90": (DEEPSEEK, {}, {"num_experts": 6, "shared_d_ff": 90}),
})


def metrics(name: str, mesh=None) -> list:
    """``train_loop``'s metrics of ``RUNS[name]`` in float32 on the CPU,
    sharded over ``mesh`` when one is given."""
    arch, over, moe = RUNS[name]
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, dtype=torch.float32, **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    return train_loop(model, OptConfig(lr=3e-3), data, STEPS,
                      zero_extras(spec, cfg, BATCH, SEQ, "cpu"), mesh=mesh)["metrics"]


RANKS = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[2])
from test_torch_tensor_parallel import RUNS, metrics
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh

leaves = [0]
leave = sharding.TensorParallel.leave


def counted(self, y):
    leaves[0] += 1
    return leave(self, y)


sharding.TensorParallel.leave = counted
dist.init_process_group("gloo")
mesh = make_host_mesh(4, "cpu")
out = {}
for name in RUNS:
    leaves[0] = 0
    out[name] = {"metrics": metrics(name, mesh), "split_blocks": leaves[0],
                 "mesh": list(mesh.shape)}
if dist.get_rank() == 0:
    json.dump(out, open(sys.argv[1], "w"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    (d / "ranks.py").write_text(RANKS)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         str(d / "ranks.py"), str(d / "out.json"), HERE],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("name", list(RUNS))
def test_model_parallel_4_matches_one_device(split, name):
    got = split[name]
    assert got["mesh"] == [1, 4] and got["split_blocks"] >= STEPS
    one = metrics(name)
    assert len(got["metrics"]) == len(one) == STEPS
    for a, b in zip(got["metrics"], one):
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["gnorm"], b["gnorm"], rtol=1e-5)
