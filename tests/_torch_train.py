"""The JAX reference of the port's train-step tests (``test_torch_train*.py``):
three steps of the JAX ``make_train_step`` per architecture, and the checks
that hold the port's ``Model.loss``, gradients and steps to it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.mesh import make_host_mesh
from repro.models.transformer import Model as JModel
from repro.train import optimizer as JO
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.models.convert import (flatten_jax, jax_layout, load_jax_opt_state,
                                        load_jax_params)
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as O
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.train_step import make_train_step
from test_torch_models import B, S, _batch

STEPS, LR = 3, 3e-3


def T(x):
    return torch.from_numpy(np.array(x))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_at(spec, cfg, step: int) -> dict:
    """``SyntheticLMData.batch_at(step)`` at (B, S), with the arch's extras
    drawn from a seed (test_torch_models's ``_batch``)."""
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    batch = _batch(spec, cfg, np.random.default_rng(100 + step))
    batch.update(data.batch_at(step))
    return batch


def _jax_run(arch):
    """The JAX model's float32 params and AdamW state, then STEPS steps of
    ``make_train_step`` on the host mesh (one jit): each step's batch, its
    metrics, the first step's gradients and the final params (all numpy).
    The gradients are read off the first step's first moment, which is
    ``(1 - b1)·clip·g`` from a zero state (exact to an ulp or two), so the
    reference costs one compile an arch."""
    spec = jget_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, dtype=jnp.float32)
    model = JModel(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    opt_cfg = JO.OptConfig(lr=LR)
    opt = JO.adamw_init(params, opt_cfg)
    step_fn = jax.jit(jmake_train_step(model, make_host_mesh(), opt_cfg=opt_cfg,
                                       total_steps=STEPS))
    out = {"params": _numpy(params), "opt": _numpy(opt), "batches": [], "metrics": []}
    for step in range(STEPS):
        batch = _batch_at(spec, cfg, step)
        params, opt, metrics = step_fn(params, opt, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.int32(step))
        out["batches"].append(batch)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if step == 0:
            clip = min(1.0, opt_cfg.grad_clip / (out["metrics"][0]["gnorm"] + 1e-9))
            out["grads"] = {k[len("mu/"):-len("/m")]: m / ((1 - opt_cfg.b1) * clip)
                            for k, m in flatten_jax(_numpy(opt)).items() if k.endswith("/m")}
    out["final"] = flatten_jax(_numpy(params))
    return out


@pytest.fixture(scope="module")
def jax_run():
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _jax_run(arch)
        return runs[arch]
    return get


def _port(arch, params, **overrides):
    cfg = dataclasses.replace(get_arch(arch).smoke_config, dtype=torch.float32, **overrides)
    return load_jax_params(Model(cfg, device="cpu"), params)


def _grads(model) -> dict:
    return jax_layout(O.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p), model.tree()))


def _close_grads(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def check_loss_and_grads(run, arch):
    """The port's loss and gradients at the JAX run's first step."""
    model = _port(arch, run["params"])
    loss = model.loss({k: T(v) for k, v in run["batches"][0].items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), run["metrics"][0]["loss"], rtol=1e-5)
    _close_grads(_grads(model), run["grads"])


def check_train_steps(run, arch):
    """STEPS steps from the JAX (params, opt_state): loss and gnorm each step,
    then each leaf's update against the JAX one's."""
    model = _port(arch, run["params"])
    opt = load_jax_opt_state(model, run["opt"])
    step_fn = make_train_step(model, O.OptConfig(lr=LR), total_steps=STEPS)
    for step, (batch, want) in enumerate(zip(run["batches"], run["metrics"])):
        metrics = step_fn(opt, {k: T(v) for k, v in batch.items()}, step)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), want[k], rtol=1e-4, err_msg=k)
        step_fn.apply(opt, metrics)
    assert int(opt["count"]) == STEPS
    p0 = flatten_jax(run["params"])
    for k, got in jax_layout(model.tree()).items():
        want = run["final"][k] - p0[k]
        err = np.linalg.norm((got - p0[k]) - want)
        assert err <= 1e-2 * np.linalg.norm(want) + 1e-12, (k, err, np.linalg.norm(want))
