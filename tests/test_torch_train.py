"""The port's LM training (``Model.loss``, ``repro_torch.train``) against the
JAX package's (``Model.loss``, ``repro.train``), on the CPU, in float32.

  * **each architecture** at its smoke config (deepseek and jamba in
    test_torch_train_mla_mamba.py, beside this file), the JAX parameters and
    optimizer state carried across (``load_jax_params``,
    ``load_jax_opt_state``), the batches ``SyntheticLMData.batch_at(step)``
    with the arch's extras drawn from a seed: ``Model.loss`` within rtol 1e-5
    and every leaf's gradient within atol 1e-4·max|g| of the leaf of the
    JAX ``Model.loss``'s (``jax.value_and_grad`` in the first step of
    ``make_train_step``, read off its first moment); then three steps of the JAX
    ``make_train_step`` (on ``make_host_mesh()``) against the port's: loss
    and gnorm within rtol 1e-4 at every step, and each leaf's update over
    the three steps within 1e-2 of the JAX one's L2 norm (Adam's first steps
    are near sign functions: a gradient entry within rounding of 0 moves its
    weight by ±lr in either package);
  * **the chunked loss**: ``loss_chunk`` dividing S, not dividing it, equal
    to it and above it give the JAX loss and gradients (masked targets,
    gemma2's logit softcap too); remat 'none', 'minimal' and 'dots' give
    bit-identical loss and gradients, and recompute what each promises;
  * **the optimizer** on identical numpy inputs: ``_quantize`` and
    ``_dequantize`` bit-equal to the JAX functions (and a stacked leaf's
    scales the concatenation of its units'), ``adamw_update`` in 32-bit,
    8-bit and with master weights within 4 ulp under the clip (8-bit codes
    equal or one apart at a rounding edge), within 1e-5 of the leaf's
    scale when it clips (the gnorms' last bits differ),
    ``lr_schedule`` within 1 ulp; tests/test_train_infra.py's quadratic,
    quantise bound, 8-bit tracking and data pipeline on the port;
  * **the guard**: a step with a poisoned parameter is rejected and leaves
    the parameters, moments and count as they were.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

from repro.configs import get_arch as jget_arch
from repro.models.transformer import Model as JModel
from repro.train import optimizer as JO
from repro.train.train_step import lr_schedule as jlr_schedule
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.distributed import StepGuard
from repro_torch.models.convert import flatten_jax, jax_layout
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as O
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.train_step import lr_schedule, make_train_step
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from _torch_train import (LR, T, _batch_at, _close_grads, _grads, _numpy, _port,
                          check_loss_and_grads, check_train_steps, jax_run)  # noqa: F401

# deepseek (MLA) and jamba (mamba) compile for the longest in JAX: they run
# in test_torch_train_mla_mamba.py, beside this file
HEAVY = ("deepseek-v2-lite-16b", "jamba-1.5-large-398b")
ARCHS = [a for a in ARCH_NAMES if a not in HEAVY]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(jax_run, arch):
    check_loss_and_grads(jax_run(arch), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_jax(jax_run, arch):
    check_train_steps(jax_run(arch), arch)


# ---------------------------------------------------------------------------
# the chunked loss and remat
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(arch, batch):
    spec = jget_arch(arch)
    model = JModel(dataclasses.replace(spec.smoke_config, dtype=jnp.float32))
    params, _ = model.init(jax.random.PRNGKey(1))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return _numpy(params), float(loss), flatten_jax(_numpy(grads))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-27b"])
def test_loss_chunks_give_one_value(arch):
    """S = 16 with a quarter of the targets masked (-1): chunks of 4 (four),
    5 (not dividing: one chunk), 16 and 512 give the JAX loss and grads."""
    spec = jget_arch(arch)
    rng = np.random.default_rng(3)
    V = spec.smoke_config.vocab_size
    batch = {"tokens": rng.integers(0, V, (2, 16)).astype(np.int32),
             "targets": np.where(rng.random((2, 16)) < 0.25, -1,
                                 rng.integers(0, V, (2, 16))).astype(np.int32)}
    params, want, want_grads = _jax_loss_and_grads(arch, batch)
    for chunk in (4, 5, 16, 512):
        model = _port(arch, params, loss_chunk=chunk)
        loss = model.loss({k: T(v) for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5, err_msg=str(chunk))
        _close_grads(_grads(model), want_grads)


class _CountBmm(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the batch-1 ``bmm`` calls (weight products) and the others."""

    def __init__(self):
        super().__init__()
        self.weight = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.bmm.default:
            if args[0].shape[0] == 1:
                self.weight += 1
            else:
                self.batched += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b", "seamless-m4t-medium"])
def test_remat_modes_identical(arch):
    """'none', 'minimal' and 'dots' give the same loss and grads bit for bit;
    the backward pass recomputes every product under 'minimal', only the
    batched ones (attention) under 'dots', none under 'none'."""
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, dtype=torch.float32)
    batch = {k: T(v) for k, v in _batch_at(spec, cfg, 0).items()}
    runs = {}
    for mode in ("none", "minimal", "dots"):
        model = Model(dataclasses.replace(cfg, remat=mode), device="cpu",
                      generator=torch.Generator().manual_seed(0))
        loss = model.loss(batch)
        with _CountBmm() as counts:
            loss.backward()
        runs[mode] = loss, _grads(model), counts
    for mode in ("minimal", "dots"):
        assert torch.equal(runs[mode][0], runs["none"][0]), mode
        for k, g in runs["none"][1].items():
            np.testing.assert_array_equal(runs[mode][1][k], g, err_msg=f"{mode} {k}")
    none, minimal, dots = (runs[m][2] for m in ("none", "minimal", "dots"))
    assert minimal.weight > dots.weight == none.weight
    assert minimal.batched == dots.batched > none.batched or arch != "qwen3-0.6b"


def test_remat_only_under_grad():
    """Under no_grad the loss runs no checkpoint (remat applies only when
    grad is enabled) and gives the grad-enabled value."""
    spec = get_arch("qwen3-0.6b")
    model = Model(dataclasses.replace(spec.smoke_config, dtype=torch.float32), device="cpu")
    batch = {k: T(v) for k, v in _batch_at(spec, model.cfg, 1).items()}
    with torch.no_grad():
        cold = model.loss(batch)
    assert not cold.requires_grad
    assert torch.equal(cold, model.loss(batch).detach())


# ---------------------------------------------------------------------------
# the optimizer against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 300), (5,), (3, 128), (2, 3, 130), (4, 1)])
def test_quantize_dequantize_bit_equal(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, 1e-30, -5.0]
    q, s = O._quantize(T(x))
    jq, js = JO._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8
    for floor in (False, True):
        np.testing.assert_array_equal(
            O._dequantize(q, s, x.shape, floor=floor).numpy(),
            np.asarray(JO._dequantize(jq, js, x.shape, floor=floor)))


def test_stacked_scales_are_the_units_scales():
    """_quantize blocks each row of the last dim: the scales of a stacked
    (G, ...) leaf are its units' scales concatenated, its codes stacked."""
    x = np.random.default_rng(0).standard_normal((3, 4, 5, 200)).astype(np.float32)
    jq, js = JO._quantize(jnp.asarray(x))
    units = [O._quantize(T(x[g])) for g in range(3)]
    np.testing.assert_array_equal(np.stack([q.numpy() for q, _ in units]), np.asarray(jq))
    np.testing.assert_array_equal(np.concatenate([s.numpy() for _, s in units]),
                                  np.asarray(js))


def _opt_inputs(rng):
    params = {"a": rng.standard_normal((4, 130)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                    "d": rng.standard_normal((2, 3, 5)).astype(np.float32)}}
    return params


@pytest.mark.parametrize("bits,master", [(32, False), (8, False), (32, True), (8, True)])
def test_adamw_update_equals_jax(bits, master):
    """Four updates, each from the same numpy (grads, state, params), gnorm
    within rtol 1e-6. The first three under the clip (gnorm < 1, so both
    clip factors are exactly 1): new params and float moments within 4 ulp,
    8-bit codes equal or, at a rounding edge, one apart. The fourth clipped
    (gnorm 10-30): the two gnorms, summed in other orders, may differ in
    their last bit, and so may every clipped grad; within atol 1e-5·max|x|."""
    rng = np.random.default_rng(bits + master)
    cfg = O.OptConfig(lr=0.05, state_bits=bits, master_weights=master)
    jcfg = JO.OptConfig(lr=0.05, state_bits=bits, master_weights=master)
    params = _opt_inputs(rng)
    state = _numpy(JO.adamw_init(jax.tree.map(jnp.asarray, params), jcfg))
    for it, scale in enumerate((1e-3, 1e-2, 2e-2, 1.0)):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                             .astype(np.float32), params)
        grads["b"]["c"][0] = 0.0
        lr = np.float32(0.05 * (it + 1) / 4)
        jp, js, jg = JO.adamw_update(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, state),
                                     jax.tree.map(jnp.asarray, params), jnp.asarray(lr), jcfg)
        pp, ps, pg = O.adamw_update(O.tree_map(T, grads), O.tree_map(T, state),
                                    O.tree_map(T, params), torch.tensor(lr), cfg)
        np.testing.assert_allclose(float(pg), float(jg), rtol=1e-6)
        clipped = float(jg) > cfg.grad_clip
        assert clipped == (it == 3)

        def same(got, want, key):
            if clipped:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-5 * np.abs(want).max(), err_msg=key)
            else:
                np.testing.assert_array_max_ulp(got, want, maxulp=4)
        for k, w in flatten_jax(_numpy(jp)).items():
            same(jax_layout(pp)[k], w, k)
        got_state, want_state = jax_layout(ps), flatten_jax(_numpy(js))
        assert list(got_state) == list(want_state)
        for k, w in want_state.items():
            if k.endswith("_q"):
                d = np.abs(got_state[k].astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-2, k
            elif k == "count":
                assert int(got_state[k]) == int(w) == it + 1
            else:
                same(got_state[k], w, k)
        params, state = _numpy(jp), _numpy(js)


def test_global_norm_accurate_on_large_leaves():
    """gnorm within 1e-6 of the float64 norm with a leaf of 2^22 elements,
    where an in-order float32 sum of squares loses about 1e-4."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(1 << 22, generator=gen) * 1e-3, torch.randn(7, 3, generator=gen)]
    want = float(torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in grads)))
    np.testing.assert_allclose(float(O.global_norm(grads)), want, rtol=1e-6)


def test_lr_schedule_equals_jax():
    for warmup, total in ((100, 10_000), (3, 10), (1, 1)):
        for step in (0, 1, 2, 3, 5, 9, 50, 99, 100, 101, 5000, 10_000, 20_000):
            got = lr_schedule(step, 3e-3, warmup=warmup, total=total, device="cpu")
            want = jlr_schedule(jnp.int32(step), 3e-3, warmup=warmup, total=total)
            assert got.dtype == torch.float32
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


# ---------------------------------------------------------------------------
# tests/test_train_infra.py's counterparts on the port
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = O.OptConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = O.adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = O.adamw_update(grads, state, params, cfg.lr, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(37, 300)).astype(np.float32))
    q, s = O._quantize(x)
    err = (O._dequantize(q, s, x.shape) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_adamw8bit_tracks_fp32():
    p0 = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(64,)).astype(np.float32))}
    outs = []
    for bits in (32, 8):
        cfg = O.OptConfig(lr=0.05, weight_decay=0.0, state_bits=bits)
        p = dict(p0)
        st = O.adamw_init(p, cfg)
        for _ in range(50):
            p, st, _ = O.adamw_update({"w": 2 * p["w"]}, st, p, cfg.lr, cfg)
        outs.append(p["w"].numpy())
    assert np.abs(outs[0] - outs[1]).max() < 0.05


def test_data_pipeline_deterministic():
    d1 = SyntheticLMData(vocab_size=97, seq_len=16, global_batch=4, seed=5)
    d2 = SyntheticLMData(vocab_size=97, seq_len=16, global_batch=4, seed=5)
    b1, b2 = d1.batch_at(42), d2.batch_at(42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    d2.restore({"step": 9, "seed": 5})
    assert d2.step == 9
    t, y = b1["tokens"], b1["targets"]
    assert ((t * 31 + 17) % 97 == y).mean() > 0.8


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def test_poisoned_step_rejected_and_not_applied():
    spec = get_arch("qwen3-0.6b")
    model = Model(dataclasses.replace(spec.smoke_config, dtype=torch.float32), device="cpu")
    cfg = O.OptConfig(lr=LR)
    opt = O.adamw_init(model.tree(), cfg)
    step_fn = make_train_step(model, cfg, total_steps=10)
    guard = StepGuard()
    batches = [{k: T(v) for k, v in _batch_at(spec, model.cfg, s).items()} for s in range(3)]
    for s in range(2):                                   # two good steps: nonzero moments
        metrics = step_fn(opt, batches[s], s)
        assert guard.ok({k: float(v) for k, v in metrics.items()})
        step_fn.apply(opt, metrics)
    with torch.no_grad():
        model.units[0].l0.attn.wq[0, 0, 0] = float("nan")
    before = jax_layout({"params": model.tree(), "opt": opt})
    metrics = step_fn(opt, batches[2], 2)
    assert not guard.ok({k: float(v) for k, v in metrics.items()})
    after = jax_layout({"params": model.tree(), "opt": opt})
    assert int(opt["count"]) == 2
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
