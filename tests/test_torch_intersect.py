"""The port's intersect kernels and ops against the JAX package's.

On the CPU each kernel wrapper takes its plain torch version; those are held
bit for bit against the Pallas kernels (interpret mode) and the XLA ops on
the same numpy inputs (tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as jbatch
from repro.kernels import ops as jops
from repro.kernels.intersect import intersect_count_pallas, intersect_expand_pallas
from repro_torch.core import batch as tbatch
from repro_torch.core.stream import SENTINEL
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops

from _torch_rows import T, make_case, make_rows


@pytest.mark.parametrize("cap_a", [128, 384, 640])
@pytest.mark.parametrize("cap_b", [128, 256])
def test_plain_versions_equal_pallas_interpret(cap_a, cap_b):
    a, b, bounds, lbounds = make_case(cap_a * 7 + cap_b, 8, cap_a, cap_b)
    want_c = intersect_count_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds),
                                    interpret=True, lbounds=jnp.asarray(lbounds))
    want_m, want_mc = intersect_expand_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds), interpret=True,
        lbounds=jnp.asarray(lbounds))
    got_c = K.intersect_count_ref(T(a), T(b), T(bounds), T(lbounds))
    got_m, got_mc = K.intersect_expand_ref(T(a), T(b), T(bounds), T(lbounds))
    assert got_c.dtype == got_m.dtype == got_mc.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_mc.numpy(), np.asarray(want_mc))
    assert got_c[1].item() == 0 and not got_m[1].any()


def test_plain_versions_unbounded_equal_pallas_interpret():
    a, b, _, _ = make_case(11, 6, 256, 128)
    want_c = intersect_count_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    want_m, _ = intersect_expand_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(K.intersect_count_ref(T(a), T(b)).numpy(),
                                  np.asarray(want_c))
    np.testing.assert_array_equal(K.intersect_expand_ref(T(a), T(b))[0].numpy(),
                                  np.asarray(want_m))


def test_sentinel_slots_never_match():
    """B rows end in SENTINEL, so an A slot holding SENTINEL would "match"
    without the a != SENTINEL term."""
    a = np.full((3, 128), SENTINEL, np.int32)
    a[0, :2] = [5, 9]
    b = np.full((3, 256), SENTINEL, np.int32)
    b[0, :3] = [1, 5, 9]
    got = K.intersect_count(T(a), T(b))
    mark, counts = K.intersect_expand(T(a), T(b))
    assert got.tolist() == counts.tolist() == [2, 0, 0]
    assert int(mark.sum()) == 2


@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (384, 640), (640, 128)])
def test_cpu_wrappers_take_plain_version_and_count_no_launch(cap_a, cap_b):
    a, b, bounds, lbounds = make_case(5, 16, cap_a, cap_b)
    before = (K.intersect_count.launches, K.intersect_expand.launches)
    args = (T(a), T(b), T(bounds), T(lbounds))
    assert torch.equal(K.intersect_count(*args), K.intersect_count_ref(*args))
    mark, counts = K.intersect_expand(*args)
    want_m, want_c = K.intersect_expand_ref(*args)
    assert torch.equal(mark, want_m) and torch.equal(counts, want_c)
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jbatch.batch_inter_count(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds), jnp.asarray(lbounds))))
    assert (K.intersect_count.launches, K.intersect_expand.launches) == before


def _bad_inputs():
    a = torch.zeros((4, 128), dtype=torch.int32)
    b = torch.zeros((4, 256), dtype=torch.int32)
    return {
        "dtype": (a.long(), b, None),
        "1-D": (a[0], b, None),
        "non-contiguous": (torch.zeros((4, 256), dtype=torch.int32)[:, ::2], b, None),
        "cap not LANE multiple": (torch.zeros((4, 100), dtype=torch.int32), b, None),
        "row mismatch": (a, b[:3], None),
        "bounds shape": (a, b, torch.zeros(3, dtype=torch.int32)),
        "bounds dtype": (a, b, torch.zeros(4, dtype=torch.int64)),
        "device": (a.to("meta"), b.to("meta"), None),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    a, b, bounds = _bad_inputs()[case]
    with pytest.raises(ValueError):
        K.intersect_count(a, b, bounds)
    with pytest.raises(ValueError):
        K.intersect_expand(a, b, bounds)


@pytest.mark.parametrize("cap_a,cap_b", [(128, 256), (384, 128), (640, 640)])
def test_xinter_count_equals_jax_xla(cap_a, cap_b):
    a, b, bounds, lbounds = make_case(cap_a + cap_b, 32, cap_a, cap_b)
    got = tops.xinter_count(T(a), T(b), T(bounds), lbounds=T(lbounds))
    want = jops.xinter_count(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds),
                             backend="xla", lbounds=jnp.asarray(lbounds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap_a,cap_b,out_cap,out_items", [
    (128, 128, None, None), (384, 256, 256, 4096), (640, 128, 128, 2048),
    (256, 640, None, 10240)])
def test_xinter_compact_equals_jax_xla(cap_a, cap_b, out_cap, out_items):
    """All six outputs, on a chunk whose tail rows carry bound 0 (padding)."""
    a, b, bounds, lbounds = make_case(cap_a * 3 + cap_b, 16, cap_a, cap_b)
    bounds[12:] = 0
    got = tops.xinter_compact(T(a), T(b), T(bounds), out_cap=out_cap,
                              out_items=out_items, lbounds=T(lbounds))
    want = jops.xinter_compact(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds),
                               out_cap=out_cap, out_items=out_items, backend="xla",
                               lbounds=jnp.asarray(lbounds))
    names = ("rows", "counts", "src", "verts", "total", "maxc")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[4]) > 0


@pytest.mark.parametrize("out_cap,out_items", [(128, 512), (256, 64), (384, 100000)])
def test_batch_compact_scan_drops_like_reference(out_cap, out_items):
    """Survivors past out_cap / out_items are dropped, as JAX's mode="drop"
    scatters drop them (torch scatters them into a sliced-off dump slot)."""
    rng = np.random.default_rng(out_cap + out_items)
    a = make_rows(rng, 12, 384, hi=5000, empty_prob=0.0)
    keep = rng.random(a.shape) < 0.8
    got = tbatch.batch_compact_scan(T(a), T(keep), out_cap, out_items)
    want = jbatch.batch_compact_scan(jnp.asarray(a), jnp.asarray(keep), out_cap,
                                     out_items)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batch_inter_compact_equals_reference():
    a, b, bounds, lbounds = make_case(21, 10, 256, 384)
    got = tbatch.batch_inter_compact(T(a), T(b), T(bounds), 256, 2560, lbounds=T(lbounds))
    want = jbatch.batch_inter_compact(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds),
                                      256, 2560, lbounds=jnp.asarray(lbounds))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
