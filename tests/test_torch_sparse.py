"""The port's S_VINTER applications (repro_torch.sparse) against the JAX
package's (``backend="xla"``) and against dense float64 numpy products, at
tests/test_sparse.py's sizes, on the CPU (the ``vinter`` kernel's plain
version). Tolerance rtol 1e-5, atol 1e-6: f32 sparse dots of a few terms,
summed in another order."""
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.svinter import vinter_pallas
from repro.sparse import from_dense as jfrom_dense
from repro.sparse import random_csf as jrandom_csf
from repro.sparse import random_sparse as jrandom_sparse
from repro.sparse import spmsp_matmul as jspmsp_matmul
from repro.sparse import ttv as jttv
from repro_torch.core.stream import SENTINEL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import svinter as SV
from repro_torch.sparse import from_dense, random_csf, random_sparse, spmsp_matmul, ttv

from _torch_rows import T, make_rows, make_values

SRC = Path(__file__).resolve().parents[1] / "src"


def _rand_sparse_dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((m, n)) < density,
                    rng.normal(size=(m, n)), 0.0).astype(np.float32)


@pytest.mark.parametrize("density,seed", [(0.02, 0), (0.15, 3), (0.4, 7)])
@pytest.mark.parametrize("block", [8, 64])
def test_spmm_equals_jax_and_dense(density, seed, block):
    a_d = _rand_sparse_dense(40, 30, density, seed)
    b_d = _rand_sparse_dense(30, 25, density, seed + 1)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    before = SV.vinter.launches
    c = spmsp_matmul(a, b, row_block=block, col_block=block, device="cpu")
    assert SV.vinter.launches == before and c.dtype == np.float32
    want = jspmsp_matmul(jfrom_dense(a_d), jfrom_dense(b_d, "csc"), row_block=block,
                         col_block=block, backend="xla")
    np.testing.assert_allclose(c, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c, a_d.astype(np.float64) @ b_d, rtol=1e-5, atol=1e-6)


def test_spmm_empty_rows_and_shape_check():
    a_d = _rand_sparse_dense(12, 10, 0.3, 1)
    a_d[3] = 0
    b_d = _rand_sparse_dense(10, 9, 0.3, 2)
    b_d[:, 4] = 0
    c = spmsp_matmul(from_dense(a_d), from_dense(b_d, "csc"), device="cpu")
    assert not c[3].any() and not c[:, 4].any()
    np.testing.assert_allclose(c, a_d.astype(np.float64) @ b_d, rtol=1e-5, atol=1e-6)
    assert not spmsp_matmul(from_dense(np.zeros((4, 5))), from_dense(b_d[:5], "csc"),
                            device="cpu").any()
    with pytest.raises(ValueError):
        spmsp_matmul(from_dense(a_d), from_dense(b_d[:9], "csc"), device="cpu")


@pytest.mark.parametrize("sparse_vec", [False, True])
@pytest.mark.parametrize("fiber_block", [16, 512])
def test_ttv_equals_jax_and_dense(sparse_vec, fiber_block):
    t, jt = random_csf((12, 9, 30), 250, seed=6), jrandom_csf((12, 9, 30), 250, seed=6)
    rng = np.random.default_rng(8)
    if sparse_vec:
        keys = np.sort(rng.choice(30, size=11, replace=False)).astype(np.int32)
        vals = rng.normal(size=11).astype(np.float32)
        vec = np.zeros(30, np.float64)
        vec[keys] = vals
    else:
        keys = np.arange(30, dtype=np.int32)
        vals = rng.normal(size=30).astype(np.float32)
        vec = vals.astype(np.float64)
    ii, jj, vv = ttv(t, keys, vals, fiber_block=fiber_block, device="cpu")
    wi, wj, wv = jttv(jt, keys, vals, fiber_block=fiber_block, backend="xla")
    np.testing.assert_array_equal(ii, np.asarray(wi))
    np.testing.assert_array_equal(jj, np.asarray(wj))
    np.testing.assert_allclose(vv, np.asarray(wv), rtol=1e-5, atol=1e-6)
    dense = np.zeros((12, 9, 30), np.float64)
    for f in range(t.num_fibers):
        lo, hi = t.fiber_ptr[f], t.fiber_ptr[f + 1]
        dense[t.i_ids[f], t.j_ids[f], t.k_ids[lo:hi]] = t.vals[lo:hi]
    got = np.zeros((12, 9))
    got[ii, jj] = vv
    np.testing.assert_allclose(got, dense @ vec, rtol=1e-5, atol=1e-6)


def test_ttv_vector_rides_as_one_row(monkeypatch):
    """Each fibre block reads one vector row expanded over the block (row
    stride 0), not a copy per fibre."""
    seen = []
    real = SV.vinter

    def spy(a_keys, a_vals, b_keys, b_vals, op="mac"):
        seen.append((b_keys.stride(0), b_vals.stride(0), a_keys.shape[0]))
        return real(a_keys, a_vals, b_keys, b_vals, op)

    monkeypatch.setattr("repro_torch.kernels.ops.vinter", spy)
    t = random_csf((12, 9, 30), 250, seed=6)
    ttv(t, np.arange(30, dtype=np.int32), np.ones(30, np.float32), fiber_block=32,
        device="cpu")
    assert seen and all(s == (0, 0, min(32, t.num_fibers - 32 * i))
                        for i, s in enumerate(seen))


def test_containers_equal_jax():
    """The numpy containers: the port's copy of sparse/matrix.py differs from
    its original only in its import line, and builds the same arrays."""
    orig = (SRC / "repro" / "sparse" / "matrix.py").read_text().splitlines()
    port = (SRC / "repro_torch" / "sparse" / "matrix.py").read_text().splitlines()
    diff = [(o, p) for o, p in zip(orig, port) if o != p]
    assert len(orig) == len(port) and diff == [
        ("from repro.core.stream import SENTINEL, round_capacity",
         "from repro_torch.core.stream import SENTINEL, round_capacity")]
    for fmt in ("csr", "csc"):
        a, ja = random_sparse(20, 15, 0.2, 4, fmt), jrandom_sparse(20, 15, 0.2, 4, fmt)
        assert type(a).__name__ == type(ja).__name__ and a.shape == ja.shape
        for f in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))
        rows = np.arange(len(a.indptr) - 1)
        for x, y in zip(a.padded_rows(rows), ja.padded_rows(rows)):
            np.testing.assert_array_equal(x, y)
    t, jt = random_csf((5, 4, 7), 40, seed=1), jrandom_csf((5, 4, 7), 40, seed=1)
    for f in ("i_ids", "j_ids", "fiber_ptr", "k_ids", "vals"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f))


def test_entry_points_default_to_the_card():
    for fn in (spmsp_matmul, ttv):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def grid_case(seed, nr, nc, cap_a, cap_b, dyadic=True):
    """Two stacks of S_VINTER rows, some empty, keys drawn where they
    overlap; A's row 0 and B's row 0 share their first keys."""
    rng = np.random.default_rng(seed)
    hi = cap_a + cap_b
    a = make_rows(rng, nr, cap_a, hi, empty_prob=0.15)
    b = make_rows(rng, nc, cap_b, hi, empty_prob=0.15)
    n = min(cap_a, cap_b)
    a[0], b[0] = SENTINEL, SENTINEL
    b[0, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    a[0, :n] = b[0, :n]
    va = np.where(a != SENTINEL, make_values(rng, a.shape, dyadic), 0).astype(np.float32)
    vb = np.where(b != SENTINEL, make_values(rng, b.shape, dyadic), 0).astype(np.float32)
    return a, va, b, vb


@pytest.mark.parametrize("op", ("mac", "max", "min"))
@pytest.mark.parametrize("nr,nc,cap_a,cap_b", [(5, 7, 128, 128), (9, 4, 128, 256),
                                               (3, 6, 256, 128)])
def test_vinter_grid_plain_version_equals_pallas_on_repeated_rows(nr, nc, cap_a, cap_b, op):
    """vinter_grid's plain version against the JAX package's vinter_pallas
    (interpret mode) over np.repeat / np.tile rows: dyadic values bit for
    bit, values in [0.5, 2) within rtol 1e-6 (f32 sums in another order);
    no kernel launch on the CPU."""
    for dyadic in (True, False):
        a, va, b, vb = grid_case(nr * nc + cap_a + cap_b, nr, nc, cap_a, cap_b, dyadic)
        before = (SV.vinter.launches, SV.vinter_grid.launches)
        got = SV.vinter_grid(T(a), T(va), T(b), T(vb), op)
        assert (SV.vinter.launches, SV.vinter_grid.launches) == before
        assert got.shape == (nr, nc) and got.dtype == torch.float32
        pairs = (np.repeat(a, nc, 0), np.repeat(va, nc, 0), np.tile(b, (nr, 1)),
                 np.tile(vb, (nr, 1)))
        want = np.asarray(vinter_pallas(*map(jnp.asarray, pairs), op=op,
                                        interpret=True)).reshape(nr, nc)
        if dyadic:
            np.testing.assert_array_equal(got.numpy(), want)
            assert got[0, 0].item() > 0
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert torch.equal(tops.xvinter_grid(T(a), T(va), T(b), T(vb), op), got)
        assert torch.equal(SV.vinter_grid_ref(T(a), T(va), T(b), T(vb), op), got)


def _bad_grid_inputs():
    k, v = torch.zeros((4, 128), dtype=torch.int32), torch.zeros((4, 128))
    wide = torch.zeros((4, 256), dtype=torch.int32)
    return {
        "op": (k, v, k, v, "sum"),
        "key dtype": (k.long(), v, k, v, "mac"),
        "value dtype": (k, v, k, v.double(), "mac"),
        "cap": (torch.zeros((4, 100), dtype=torch.int32), torch.zeros((4, 100)), k, v, "mac"),
        "values shape": (k, v, wide, v, "mac"),
        "b non-contiguous": (k, v, wide[:, ::2], v, "mac"),
        "b broadcast": (k, v, k[:1].expand(4, 128), v[:1].expand(4, 128), "mac"),
        "device": (k.to("meta"), v.to("meta"), k.to("meta"), v.to("meta"), "mac"),
    }


@pytest.mark.parametrize("case", sorted(_bad_grid_inputs()))
def test_vinter_grid_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        SV.vinter_grid(*_bad_grid_inputs()[case])


@pytest.mark.parametrize("block", [8, 16])
def test_spmm_calls_the_grid_form_once_a_block_on_uncopied_rows(block, monkeypatch):
    """spmsp_matmul through vinter_grid equals the JAX package's spmm (its
    xvinter over np.repeat / np.tile pairs) and the dense product: one grid
    call per (row block, column block), as many as the JAX package's
    launches, each on the block's own rows (views of the padded stacks, not
    copies per pair); no kernel launch on the CPU."""
    a_d = _rand_sparse_dense(40, 30, 0.15, block)
    b_d = _rand_sparse_dense(30, 25, 0.15, block + 1)
    a_d[5], b_d[:, 3] = 0, 0
    seen = []
    real = SV.vinter_grid

    def spy(ak, av, bk, bv, op="mac"):
        seen.append((ak._base is not None, bk._base is not None, ak.shape[0], bk.shape[0]))
        return real(ak, av, bk, bv, op)

    monkeypatch.setattr("repro_torch.kernels.ops.vinter_grid", spy)
    before = (SV.vinter.launches, SV.vinter_grid.launches)
    c = spmsp_matmul(from_dense(a_d), from_dense(b_d, "csc"), row_block=block,
                     col_block=block, device="cpu")
    assert (SV.vinter.launches, SV.vinter_grid.launches) == before
    rows, cols = int((a_d != 0).any(1).sum()), int((b_d != 0).any(0).sum())
    assert len(seen) == -(-rows // block) * -(-cols // block)
    assert all(va and vb and nr <= block and nc <= block for va, vb, nr, nc in seen)
    want = jspmsp_matmul(jfrom_dense(a_d), jfrom_dense(b_d, "csc"), row_block=block,
                         col_block=block, backend="xla")
    np.testing.assert_allclose(c, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c, a_d.astype(np.float64) @ b_d, rtol=1e-5, atol=1e-6)
