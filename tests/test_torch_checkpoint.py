"""The port's checkpoints, training launcher and training examples, on the CPU.

  * ``CheckpointManager``: tests/test_train_infra.py's round trip with
    pruning; a model's tree and 8-bit state through ``save``/``restore``
    bit for bit (units stacked on disk, split back); a checkpoint written by
    the JAX package (after two JAX steps) restored by the port, and one
    written by the port restored by the JAX package: the next step's loss and
    gnorm equal the other package's within rtol 1e-5, in 32-bit and 8-bit
    state;
  * ``python -m repro_torch.launch.train --device cpu``, tests/test_system.py's
    counterparts: it runs to ``[train] done`` with no nan; a crash
    (``--inject-failure``, exit 17) and a restart resume past the crash, and
    the resumed steps print the uninterrupted run's losses and leave its final
    checkpoint bit for bit; ``--model-parallel 2`` is refused; without
    ``--device cpu`` the launcher, the examples and ``Model`` raise (no card
    here, and no fallback to the CPU);
  * ``examples/train_100m_torch.py --device cpu`` (2 steps at 2 x 16) prints
    the JAX example's parameter count and finite losses, and
    ``examples/fault_tolerance_demo_torch.py --device cpu`` runs to its last
    line.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.mesh import make_host_mesh
from repro.models.transformer import Model as JModel
from repro.models.transformer import ModelConfig as JModelConfig
from repro.models.transformer import param_count as jparam_count
from repro.train import optimizer as JO
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import jax_layout, load_jax_params
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import CheckpointManager, assign_
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.train_step import make_train_step
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"
TRAIN = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--batch", "2", "--seq", "16"]
STEP_LINE = re.compile(r"\[train\] step (\d+) (loss=\S+ gnorm=\S+ lr=\S+)")


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    params = {"a": torch.arange(6.0).reshape(2, 3),
              "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    for step in (3, 7, 11):
        cm.save(step, params, data_state={"step": step, "seed": 0})
    assert cm.steps() == [7, 11]          # pruned to keep_last
    like = O.tree_map(lambda t: torch.empty_like(t, device="meta"), params)
    got, opt, manifest = cm.restore(None, like)
    assert manifest["step"] == 11 and opt is None
    assert torch.equal(got["a"], params["a"]) and torch.equal(got["b"]["c"], params["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32 and got["a"].device.type == "cpu"


@pytest.mark.parametrize("bits", [32, 8])
def test_model_checkpoint_roundtrip(tmp_path, bits):
    """A trained model's tree and state, stacked on disk as the JAX package
    stacks them, come back split and equal bit for bit."""
    spec = get_arch(ARCH)                              # 2 units: scales split by rows
    model = Model(spec.smoke_config, device="cpu")
    assert model.cfg.num_units == 2
    cfg = O.OptConfig(lr=1e-2, state_bits=bits)
    opt = O.adamw_init(model.tree(), cfg)
    step_fn = make_train_step(model, cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(spec.smoke_config.vocab_size, 8, 2).batch_at(0).items()}
    step_fn.apply(opt, step_fn(opt, batch, 150))
    cm = CheckpointManager(str(tmp_path))
    path = cm.save(0, model.tree(), opt, {"step": 0, "seed": 0})
    with open(os.path.join(path, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    assert keys[0] == "opt/count" and keys[-1].startswith("params/units/")
    with np.load(os.path.join(path, "arrays.npz")) as saved:
        assert saved[f"a{keys.index('params/units/l0/attn/wq')}"].shape == (2, 64, 4, 16)
    params, got_opt, _ = cm.restore(None, Model(spec.smoke_config, device="meta").tree(),
                                    O.adamw_init(model.tree(), cfg))
    want, got = jax_layout({"p": model.tree(), "o": opt}), jax_layout({"p": params, "o": got_opt})
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


# ---------------------------------------------------------------------------
# each package restores the other's checkpoints
# ---------------------------------------------------------------------------

def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(step):
    cfg = get_arch(ARCH).smoke_config
    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2).batch_at(step)


@pytest.mark.parametrize("bits", [32, 8])
def test_checkpoints_cross_packages(tmp_path, bits):
    """Two JAX steps, saved by the JAX package; the port restores them and
    takes the third step. Two port steps from the same start, saved by the
    port; the JAX package restores them and takes the third. Each third step
    gives the other package's loss and gnorm."""
    jcfg = dataclasses.replace(jget_arch(ARCH).smoke_config, dtype=jnp.float32)
    jmodel = JModel(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    jopt_cfg = JO.OptConfig(lr=1e-2, state_bits=bits)
    step_fn = jax.jit(jmake_train_step(jmodel, make_host_mesh(), opt_cfg=jopt_cfg,
                                       total_steps=10))
    p0 = _numpy(params)
    jopt = JO.adamw_init(params, jopt_cfg)
    jmetrics = []
    for step in range(3):
        if step == 2:
            JCheckpointManager(str(tmp_path / "jax")).save(
                1, params, jopt, {"step": 1, "seed": 0})
        batch = {k: jnp.asarray(v) for k, v in _batch(step).items()}
        params, jopt, m = step_fn(params, jopt, batch, jnp.int32(step))
        jmetrics.append({k: float(v) for k, v in m.items()})

    cfg = dataclasses.replace(get_arch(ARCH).smoke_config, dtype=torch.float32)
    opt_cfg = O.OptConfig(lr=1e-2, state_bits=bits)

    def port_step(model, opt, step):
        fn = make_train_step(model, opt_cfg, total_steps=10)
        out = fn(opt, {k: torch.from_numpy(v) for k, v in _batch(step).items()}, step)
        fn.apply(opt, out)
        return {k: float(v) for k, v in out.items()}

    # JAX writes, the port reads
    model = Model(cfg, device="cpu")
    restored, opt, manifest = CheckpointManager(str(tmp_path / "jax")).restore(
        None, model.tree(), O.adamw_init(model.tree(), opt_cfg))
    assign_(model.tree(), restored)
    assert manifest["step"] == 1 and int(opt["count"]) == 2
    got = port_step(model, opt, 2)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(got[k], jmetrics[2][k], rtol=1e-5, err_msg=k)

    # the port writes, JAX reads
    model = load_jax_params(Model(cfg, device="cpu"), p0)
    opt = O.adamw_init(model.tree(), opt_cfg)
    port = [port_step(model, opt, step) for step in range(2)]
    CheckpointManager(str(tmp_path / "port")).save(1, model.tree(), opt, {"step": 1, "seed": 0})
    port.append(port_step(model, opt, 2))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0))[0])
    o_like = jax.eval_shape(lambda p: JO.adamw_init(p, jopt_cfg), shapes)
    jparams, jopt, _ = JCheckpointManager(str(tmp_path / "port")).restore(None, shapes, o_like)
    _, _, m = step_fn(jparams, jopt, {k: jnp.asarray(v) for k, v in _batch(2).items()},
                      jnp.int32(2))
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(port[2][k], float(m[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the launcher and the examples, in subprocesses side by side
# ---------------------------------------------------------------------------

def _spawn(args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _wait(p):
    out, err = p.communicate(timeout=400)
    return p.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    ck, ck2 = str(d / "ck"), str(d / "ck2")
    ckpt = ["--steps", "10", "--ckpt-every", "4", "--device", "cpu"]
    procs = {
        "plain": _spawn(TRAIN + ["--steps", "5", "--device", "cpu"]),
        "crash": _spawn(TRAIN + ckpt + ["--ckpt", ck, "--inject-failure", "5"]),
        "whole": _spawn(TRAIN + ckpt + ["--ckpt", ck2]),
        "100m": _spawn([str(ROOT / "examples" / "train_100m_torch.py"), "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16"]),
        "ft": _spawn([str(ROOT / "examples" / "fault_tolerance_demo_torch.py"),
                      "--device", "cpu"]),
    }
    if not torch.cuda.is_available():
        procs["card"] = _spawn(TRAIN + ["--steps", "1"])
        procs["100m card"] = _spawn([str(ROOT / "examples" / "train_100m_torch.py")])
    out = {}
    try:
        out["crash"] = _wait(procs.pop("crash"))
        procs["resume"] = _spawn(TRAIN + ckpt + ["--ckpt", ck])
        out.update((k, _wait(p)) for k, p in procs.items())
    finally:
        for p in procs.values():
            p.kill()
    out["dirs"] = ck, ck2
    return out


def test_train_launcher_runs_and_loss_finite(runs):
    rc, out, err = runs["plain"]
    assert rc == 0, err[-2000:]
    assert "[train] done" in out
    assert "nan" not in out.lower()
    assert len(STEP_LINE.findall(out)) == 5


def test_train_crash_restart_resumes(runs):
    rc, out, err = runs["crash"]
    assert rc == 17, err[-2000:]                # injected crash
    assert "[train] injected failure" in out
    rc, out, err = runs["resume"]
    assert rc == 0, err[-2000:]
    assert "restored step 3" in out
    # resumed past the crash point, not from zero
    assert "[train] step 0 " not in out


def test_resumed_run_equals_uninterrupted_bit_for_bit(runs):
    """The resumed steps print the uninterrupted run's loss, gnorm and lr at
    every step, and both runs' final checkpoints hold the same bits."""
    resumed = dict(STEP_LINE.findall(runs["resume"][1]))
    whole = dict(STEP_LINE.findall(runs["whole"][1]))
    assert runs["whole"][0] == 0 and sorted(resumed, key=int) == [str(s) for s in range(4, 10)]
    assert resumed == {s: whole[s] for s in resumed}
    ck, ck2 = runs["dirs"]
    with np.load(os.path.join(ck, "step_9", "arrays.npz")) as a, \
            np.load(os.path.join(ck2, "step_9", "arrays.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_model_parallel_refused():
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--model-parallel", "2", "--device", "cpu"])
    assert e.value.code != 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: cuda runs")
def test_entry_points_raise_without_a_card(runs):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_arch(ARCH).smoke_config)
    for name in ("card", "100m card"):
        rc, out, err = runs[name]
        assert rc != 0 and "device='cpu'" in err, (name, err[-2000:])
        assert "[train] step" not in out and "loss=" not in out


def test_train_100m_example_prints_the_jax_param_count(runs):
    rc, out, err = runs["100m"]
    assert rc == 0, err[-2000:]
    jcfg = JModelConfig(name="qwen3-100m", num_layers=10, d_model=768, num_heads=12,
                        num_kv_heads=4, head_dim=64, d_ff=2560, vocab_size=32768,
                        qk_norm=True, tie_embeddings=True, kv_repeat=2)
    lines = out.splitlines()
    assert lines[0] == f"[100m] params: {jparam_count(JModel(jcfg))/1e6:.1f}M"
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert lines[-1].startswith("[100m] final loss")


def test_fault_tolerance_demo_runs(runs):
    rc, out, err = runs["ft"]
    assert rc == 0, err[-2000:]
    lines = out.splitlines()
    assert "[ft] crash/restart: OK (resumed from the last checkpoint)" in lines
    assert any(ln.startswith("[ft] elastic restore onto cpu at step 11") for ln in lines)
    assert lines[-1] == "[ft] all fault-tolerance paths verified"
