"""The port's S_VINTER applications (repro_torch.sparse) against the JAX
package's (``backend="xla"``) and against dense float64 numpy products, at
tests/test_sparse.py's sizes, on the CPU (the ``vinter`` kernel's plain
version). Tolerance rtol 1e-5, atol 1e-6: f32 sparse dots of a few terms,
summed in another order."""
import inspect
from pathlib import Path

import numpy as np
import pytest

from repro.sparse import from_dense as jfrom_dense
from repro.sparse import random_csf as jrandom_csf
from repro.sparse import random_sparse as jrandom_sparse
from repro.sparse import spmsp_matmul as jspmsp_matmul
from repro.sparse import ttv as jttv
from repro_torch.kernels import svinter as SV
from repro_torch.sparse import from_dense, random_csf, random_sparse, spmsp_matmul, ttv

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
