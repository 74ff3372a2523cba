"""The port's int8-compressed mean (``repro_torch.distributed.compression``)
against the JAX package's: on a one-rank gloo group, the mean and the
residual bit for bit equal to ``test_train_infra.py``'s
``test_compressed_mean_single_device`` computation (``shard_map`` over a
1-device 'pod' mesh) on the same x, with and without an error-feedback
input; on two ranks, equal to the formula in numpy float32 (int32 sum of
the int8 codes, MAX of the scales, local residual). Each world runs in
subprocesses (a FileStore rendezvous, no port)."""
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed.compression import compressed_mean
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
x = np.load(out + f".x{rank}.npy")
e = np.load(out + ".e.npy")
m0, e0 = compressed_mean(torch.from_numpy(x), None)
m1, e1 = compressed_mean(torch.from_numpy(x), dist.group.WORLD, torch.from_numpy(e))
np.savez(out + f".r{rank}.npz", m0=m0.numpy(), e0=e0.numpy(), m1=m1.numpy(), e1=e1.numpy())
dist.destroy_process_group()
"""


def _world(tmp_path, xs, e) -> list:
    """compressed_mean on len(xs) gloo ranks: each rank's arrays."""
    base = str(tmp_path / "cm")
    for r, x in enumerate(xs):
        np.save(base + f".x{r}.npy", x)
    np.save(base + ".e.npy", e)
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(len(xs)),
                               str(tmp_path / "store"), base], env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(len(xs))]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    return [dict(np.load(base + f".r{r}.npz")) for r in range(len(xs))]


def _x(seed, n=64):
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)


def test_one_rank_bit_equal_to_jax(tmp_path):
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP

    from repro.distributed.compression import compressed_mean as jcm
    from repro.distributed.sharding import make_mesh_compat
    mesh = make_mesh_compat((1,), ("pod",))
    x = _x(0)
    e = (_x(1) * 1e-3).astype(np.float32)

    def jax_side(err):
        def body(x, err):
            m, ne = jcm(x, "pod", err)
            return m, ne
        f = shard_map(body, mesh=mesh, in_specs=(JP(), JP()), out_specs=(JP(), JP()),
                      check_rep=False)
        return [np.asarray(t) for t in f(jnp.asarray(x), jnp.asarray(err))]

    jm0, je0 = jax_side(np.zeros_like(x))          # err=None adds nothing
    jm1, je1 = jax_side(e)
    (got,) = _world(tmp_path, [x], e)
    assert np.array_equal(got["m0"], jm0) and np.array_equal(got["e0"], je0)
    assert np.array_equal(got["m1"], jm1) and np.array_equal(got["e1"], je1)
    # the JAX test's bound: int8 wire error within one code step
    assert np.abs(got["m0"] - x).max() <= np.abs(x).max() / 127 + 1e-6


def _formula(xs, e=None):
    """compressed_mean in numpy float32: each rank's codes and scale, the
    int32 sum, the MAX scale, the mean, each rank's residual."""
    f32 = np.float32
    xf = [x + e if e is not None else x for x in xs]
    scales = [np.max(np.abs(x)) / f32(127.0) + f32(1e-12) for x in xf]
    qs = [np.clip(np.round(x / s), -127, 127).astype(np.int8) for x, s in zip(xf, scales)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0)
    mean = (total.astype(f32) * max(scales)) / f32(len(xs))
    errs = [x - q.astype(f32) * s for x, q, s in zip(xf, qs, scales)]
    return mean, errs


@pytest.mark.parametrize("n", [64, 1000])
def test_two_ranks_equal_to_the_formula(tmp_path, n):
    xs = [_x(10 + n), (_x(11 + n) * 3).astype(np.float32)]
    e = (_x(12 + n) * 1e-2).astype(np.float32)
    got = _world(tmp_path, xs, e)
    for key_m, key_e, ee in (("m0", "e0", None), ("m1", "e1", e)):
        mean, errs = _formula(xs, ee)
        for r in range(2):
            assert np.array_equal(got[r][key_m], mean)
            assert np.array_equal(got[r][key_e], errs[r])
