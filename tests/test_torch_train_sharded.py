"""The port's sharded training (``train_step.ShardedTrainStep`` through
``launch.train``'s ``train_loop`` on its host mesh) against its one-device
run: one ``torchrun --standalone`` of 4 gloo CPU ranks trains on the (2, 2)
('data', 'model') mesh that ``--model-parallel 2`` makes, data parallel
over 'data', qwen3-0.6b and deepseek-v2-lite-16b with 8-bit state (its MoE
router's statistics and capacity ranks summed over the ranks), smoke
configs in float32; rank 0's loss and gnorm must equal the one-device
run's within rtol 1e-5. Then a checkpoint saved by ``launch.train
--model-parallel 1`` on the 4 ranks (a (4, 1) mesh) restores onto (2, 2):
every restored leaf's blocks make the saved array, each rank's block of its
sharding's shape."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_rows import one_torch_thread  # noqa: F401

from repro_torch.configs import get_arch
from repro_torch.launch.train import train_loop, zero_extras
from repro_torch.models.transformer import Model
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
STEPS, BATCH, SEQ = 3, 4, 16
RUNS = {"qwen3": ("qwen3-0.6b", 32), "deepseek8": ("deepseek-v2-lite-16b", 8)}


def f32_metrics(arch: str, state_bits: int, mesh=None) -> list:
    """``train_loop``'s metrics of ``arch``'s smoke config in float32 on the
    CPU, sharded over ``mesh`` when one is given, as ``launch.train`` builds
    the model, the data and the state."""
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, dtype=torch.float32)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    return train_loop(model, OptConfig(lr=3e-3, state_bits=state_bits), data, STEPS,
                      zero_extras(spec, cfg, BATCH, SEQ, "cpu"), mesh=mesh)["metrics"]


RANKS = r"""
import sys
import json
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[3])
from test_torch_train_sharded import RUNS, STEPS, f32_metrics
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import main
from repro_torch.models.transformer import Model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig, _state_leaves, tree_leaves
from repro_torch.train.train_step import ShardedTrainStep

ck, out_path = sys.argv[1], sys.argv[2]
dist.init_process_group("gloo")
out = {k: f32_metrics(a, bits, make_host_mesh(2, "cpu")) for k, (a, bits) in RUNS.items()}
# a checkpoint saved at (4, 1) ...
r = main(["--arch", "qwen3-0.6b", "--model-parallel", "1", "--ckpt", ck, "--device", "cpu",
          "--steps", str(STEPS), "--batch", "4", "--seq", "16"])
out["saved_on"] = list(r["step_fn"].mesh.shape)
# ... restored onto (2, 2)
mesh = make_host_mesh(2, "cpu")
cfg = get_arch("qwen3-0.6b").smoke_config
model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
step = ShardedTrainStep(model, mesh, opt_cfg=OptConfig(lr=3e-3))
opt = step.init_state()
cm = CheckpointManager(ck)
whole_p, whole_o, man = cm.restore(None, model.tree(), opt, device="cpu")
got_p, got_o, _ = cm.restore(None, model.tree(), opt, mesh=mesh,
                             param_shardings=step.param_shardings,
                             opt_shardings=step.opt_shardings)
ok, n, sharded = True, 0, 0
pairs = list(zip(tree_leaves(got_p), tree_leaves(whole_p), tree_leaves(step.param_shardings)))
for g_mu, w_mu, s_mu in zip(_state_leaves(got_o["mu"]), _state_leaves(whole_o["mu"]),
                            _state_leaves(step.opt_shardings["mu"])):
    pairs += [(g_mu[k], w_mu[k], s_mu[k]) for k in sorted(g_mu)]
for got, whole, sh in pairs:
    n += 1
    sharded += got.to_local().shape != whole.shape
    ok &= tuple(got.to_local().shape) == sh.shard_shape(tuple(whole.shape))
    ok &= bool(torch.equal(got.full_tensor(), whole))
flag = torch.tensor([int(ok)])
dist.all_reduce(flag, op=dist.ReduceOp.MIN)
out["restore"] = {"ok": bool(flag.item()), "leaves": n, "sharded": int(sharded),
                  "step": man["step"]}
if dist.get_rank() == 0:
    json.dump(out, open(out_path, "w"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    (d / "ranks.py").write_text(RANKS)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         str(d / "ranks.py"), str(d / "ck"), str(d / "out.json"), HERE],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("run", list(RUNS))
def test_model_parallel_2_matches_one_device(sharded, run):
    one = f32_metrics(*RUNS[run])
    got = sharded[run]
    assert len(got) == len(one) == 3
    for a, b in zip(got, one):
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["gnorm"], b["gnorm"], rtol=1e-5)


def test_checkpoint_at_4x1_restores_onto_2x2(sharded):
    r = sharded["restore"]
    assert sharded["saved_on"] == [4, 1]
    assert r["ok"] and r["step"] == 2
    assert r["leaves"] > 40 and r["sharded"] > 0
