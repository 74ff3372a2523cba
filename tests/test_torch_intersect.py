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
from repro.kernels.intersect import (intersect_count_pallas, intersect_expand_pallas,
                                     intersect_mark_pallas, intersect_multi_agg_pallas,
                                     intersect_multi_pallas)
from repro.kernels.svinter import vinter_pallas
from repro_torch.core import batch as tbatch
from repro_torch.core.stream import SENTINEL
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels import svinter as SV

from _torch_rows import (AGG_OPS, T, make_agg_case, make_case, make_level_case, make_rows,
                         make_vinter_case)
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

POLS = [(1,), (0,), (1, 0), (0, 0), (1, 1, 0)]


def _j(*xs):
    """numpy arrays (or None) -> JAX arrays."""
    return [None if x is None else jnp.asarray(x) for x in xs]


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


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (256, 128), (128, 256)])
def test_mark_plain_version_equals_pallas_interpret(cap_a, cap_b, bounded):
    a, b, bounds, lbounds = make_case(cap_a * 5 + cap_b + bounded, 8, cap_a, cap_b)
    if not bounded:
        bounds = lbounds = None
    ja, jb, jbd, jlb = _j(a, b, bounds, lbounds)
    want = intersect_mark_pallas(ja, jb, jbd, interpret=True, lbounds=jlb)
    got = K.intersect_mark_ref(T(a), T(b), T(bounds), T(lbounds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = K.intersect_mark.launches
    assert torch.equal(K.intersect_mark(T(a), T(b), T(bounds), T(lbounds)), got)
    assert K.intersect_mark.launches == before


@pytest.mark.parametrize("with_excludes", [True, False])
@pytest.mark.parametrize("pol", POLS)
def test_multi_plain_version_equals_pallas_interpret(pol, with_excludes):
    """Bound-0 rows, refs of full overlap, excludes holding keys of A."""
    a, bs, bounds, lbounds, excl = make_level_case(len(pol) * 31 + with_excludes,
                                                   8, 256, len(pol), 128)
    excl = excl if with_excludes else None
    ja, jbs, jbd, jlb, jex = _j(a, bs, bounds, lbounds, excl)
    want_m, want_c = intersect_multi_pallas(ja, jbs, pol, jbd, interpret=True,
                                            lbounds=jlb, excludes=jex)
    got_m, got_c = K.intersect_multi_ref(T(a), T(bs), pol, T(bounds), T(lbounds), T(excl))
    assert got_m.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[1].item() == 0 and got_c.sum().item() > 0
    before = K.intersect_multi.launches
    m, c = K.intersect_multi(T(a), T(bs), pol, T(bounds), T(lbounds), T(excl))
    assert torch.equal(m, got_m) and torch.equal(c, got_c)
    assert K.intersect_multi.launches == before


def _bad_multi_inputs():
    a = torch.zeros((4, 128), dtype=torch.int32)
    bs = torch.zeros((2, 4, 128), dtype=torch.int32)
    ex = torch.zeros((4, 2), dtype=torch.int32)
    return {
        "bs 2-D": (a, bs[0], (1,), None),
        "pol length": (a, bs, (1,), None),
        "pol not INTER-first": (a, bs, (0, 1), None),
        "pol value": (a, bs, (1, 2), None),
        "empty pol": (a, bs[:0], (), None),
        "bs rows": (a, bs[:, :3].contiguous(), (1, 0), None),
        "bs cap": (a, torch.zeros((2, 4, 100), dtype=torch.int32), (1, 0), None),
        "excludes dtype": (a, bs, (1, 0), ex.long()),
        "excludes rows": (a, bs, (1, 0), ex[:3]),
        "excludes non-contiguous": (a, bs, (1, 0), torch.zeros((4, 4), dtype=torch.int32)[:, ::2]),
        "excludes 1-D": (a, bs, (1, 0), ex[:, 0].contiguous()),
        "device": (a.to("meta"), bs.to("meta"), (1, 0), None),
    }


@pytest.mark.parametrize("case", sorted(_bad_multi_inputs()))
def test_multi_wrapper_raises_on_what_the_kernel_does_not_take(case):
    a, bs, pol, excl = _bad_multi_inputs()[case]
    with pytest.raises(ValueError):
        K.intersect_multi(a, bs, pol, excludes=excl)


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_mark_wrapper_raises_on_what_the_kernel_does_not_take(case):
    a, b, bounds = _bad_inputs()[case]
    with pytest.raises(ValueError):
        K.intersect_mark(a, b, bounds)


@pytest.mark.parametrize("cap_a,cap_b", [(128, 256), (384, 128)])
def test_xmark_and_xsub_count_equal_jax_xla(cap_a, cap_b):
    a, b, bounds, lbounds = make_case(cap_a * 2 + cap_b, 16, cap_a, cap_b)
    ja, jb, jbd, jlb = _j(a, b, bounds, lbounds)
    got = tops.xmark(T(a), T(b))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.xmark(ja, jb, backend="xla")))
    for bd, lbd in ((bounds, lbounds), (bounds, None), (None, None)):
        got = tops.xsub_count(T(a), T(b), T(bd), lbounds=T(lbd))
        want = jops.xsub_count(ja, jb, *_j(bd), backend="xla", lbounds=_j(lbd)[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            tbatch.batch_sub_count(T(a), T(b), T(bd), T(lbd)).numpy(), np.asarray(want))


COMPACT = ("rows", "counts", "src", "verts", "total", "maxc")


def _assert_six_equal(got, want):
    for name, g, w in zip(COMPACT, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("cap_a,cap_b,out_cap,out_items", [
    (128, 128, None, None), (384, 256, 256, 4096), (256, 640, 128, 1000)])
def test_xsub_compact_equals_jax_xla(cap_a, cap_b, out_cap, out_items):
    """All six outputs, on a chunk whose tail rows carry bound 0; out_cap
    defaults to cap_a."""
    a, b, bounds, lbounds = make_case(cap_a * 5 + cap_b, 16, cap_a, cap_b)
    bounds[12:] = 0
    ja, jb, jbd, jlb = _j(a, b, bounds, lbounds)
    got = tops.xsub_compact(T(a), T(b), T(bounds), out_cap=out_cap, out_items=out_items,
                            lbounds=T(lbounds))
    want = jops.xsub_compact(ja, jb, jbd, out_cap=out_cap, out_items=out_items,
                             backend="xla", lbounds=jlb)
    _assert_six_equal(got, want)
    assert got[0].shape[1] == (out_cap or cap_a) and int(got[4]) > 0
    cap, items = out_cap or cap_a, out_items or 16 * (out_cap or cap_a)
    _assert_six_equal(tbatch.batch_sub_compact(T(a), T(b), T(bounds), cap, items,
                                               lbounds=T(lbounds)), want)


@pytest.mark.parametrize("with_excludes", [True, False])
@pytest.mark.parametrize("pol", [()] + POLS)
def test_xlevel_count_and_compact_equal_jax_xla(pol, with_excludes):
    """pol = () is the window-only level: no reference stack at all."""
    a, bs, bounds, lbounds, excl = make_level_case(len(pol) * 17 + 3 * with_excludes,
                                                   16, 256, max(len(pol), 1), 128)
    bs = bs if pol else None
    excl = excl if with_excludes else None
    ja, jbs, jbd, jlb, jex = _j(a, bs, bounds, lbounds, excl)
    got = tops.xlevel_count(T(a), T(bs), pol, T(bounds), lbounds=T(lbounds),
                            excludes=T(excl))
    want = jops.xlevel_count(ja, jbs, pol, jbd, backend="xla", lbounds=jlb, excludes=jex)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tbatch.batch_level_count(T(a), T(bs), pol, T(bounds), T(lbounds), T(excl)).numpy(),
        np.asarray(want))
    got = tops.xlevel_compact(T(a), T(bs), pol, T(bounds), out_cap=256, out_items=2048,
                              lbounds=T(lbounds), excludes=T(excl))
    want = jops.xlevel_compact(ja, jbs, pol, jbd, out_cap=256, out_items=2048,
                               backend="xla", lbounds=jlb, excludes=jex)
    _assert_six_equal(got, want)
    assert int(got[4]) > 0


# k = 1, 2, 3 references, INTER and SUB polarity
AGG_POLS = [(1,), (0,), (1, 0), (1, 1), (1, 1, 0)]


def _agg_case(pol, seed, dyadic=True, bounded=True, with_excludes=True):
    a, bs, bounds, lbounds, excl, av, bv, sc = make_agg_case(seed, 8, 256, len(pol), 128,
                                                             dyadic)
    if not bounded:
        bounds = lbounds = None
    return a, bs, bounds, lbounds, excl if with_excludes else None, av, bv, sc


def _agg_all(pol, op, case):
    """(plain version, Pallas interpret, XLA twin, ops.xlevel_agg) on one case."""
    a, bs, bounds, lbounds, excl, av, bv, sc = case
    ja, jbs, jbd, jlb, jex, jav, jbv, jsc = _j(*case)
    got = K.intersect_multi_agg_ref(T(a), T(bs), pol, T(av), T(bv), T(sc), op, T(bounds),
                                    T(lbounds), T(excl))
    pallas = intersect_multi_agg_pallas(ja, jbs, pol, jav, jbv, jsc, op=op, bounds=jbd,
                                        interpret=True, lbounds=jlb, excludes=jex)
    xla = jbatch.batch_level_agg(ja, jbs, pol, jav, jbv, jsc, op=op, bounds=jbd,
                                 lbounds=jlb, excludes=jex)
    before = K.intersect_multi_agg.launches
    ops = tops.xlevel_agg(T(a), T(bs), pol, T(av), T(bv), T(sc), op, T(bounds),
                          lbounds=T(lbounds), excludes=T(excl))
    assert K.intersect_multi_agg.launches == before
    return got, [np.asarray(x) for x in pallas], [np.asarray(x) for x in xla], ops


@pytest.mark.parametrize("op", AGG_OPS)
@pytest.mark.parametrize("pol", AGG_POLS)
def test_multi_agg_plain_version_equals_pallas_interpret_and_xla(pol, op):
    """Dyadic values: marks, counts and vals bit for bit against the Pallas
    kernel and the XLA twin, with a bound-0 row (row 1: the op identity),
    lower bounds and E = 2 excludes."""
    case = _agg_case(pol, 40 + len(pol) * 7 + sum(pol))
    (m, c, v), (pm, pc, pv), (xc, xv), (oc, ov) = _agg_all(pol, op, case)
    assert m.dtype == c.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), pm)
    for got in (c, oc):
        np.testing.assert_array_equal(got.numpy(), pc)
        np.testing.assert_array_equal(got.numpy(), xc)
    for got in (v, ov):
        np.testing.assert_array_equal(got.numpy(), pv)
        np.testing.assert_array_equal(got.numpy(), xv)
    assert c[1].item() == 0 and v[1].item() == {"sum": 0.0, "max": float(np.float32(-3.4e38)),
                                                "min": float(np.float32(3.4e38))}[op]
    assert c.sum().item() > 0


@pytest.mark.parametrize("op", AGG_OPS)
def test_multi_agg_unbounded_without_excludes_equals_pallas_interpret(op):
    pol = (1, 1, 0)
    case = _agg_case(pol, 9, bounded=False, with_excludes=False)
    (m, c, v), (pm, pc, pv), (xc, xv), _ = _agg_all(pol, op, case)
    np.testing.assert_array_equal(m.numpy(), pm)
    np.testing.assert_array_equal(c.numpy(), pc)
    np.testing.assert_array_equal(v.numpy(), pv)
    np.testing.assert_array_equal(v.numpy(), xv)


@pytest.mark.parametrize("op", AGG_OPS)
def test_multi_agg_non_dyadic_values(op):
    """Values in [0.5, 2): marks and counts bit for bit; against the XLA twin
    (same multiplication order) max and min bit for bit and sums within
    rtol 1e-6 (f32 row sums in another order); against the Pallas kernel,
    which multiplies the matched values before a_vals, every op within
    rtol 1e-6."""
    pol = (1, 1, 0)
    case = _agg_case(pol, 21, dyadic=False)
    (m, c, v), (pm, pc, pv), (xc, xv), _ = _agg_all(pol, op, case)
    np.testing.assert_array_equal(m.numpy(), pm)
    np.testing.assert_array_equal(c.numpy(), xc)
    np.testing.assert_allclose(v.numpy(), pv, rtol=1e-6)
    if op == "sum":
        np.testing.assert_allclose(v.numpy(), xv, rtol=1e-6)
    else:
        np.testing.assert_array_equal(v.numpy(), xv)


def test_xlevel_agg_window_only_level_equals_jax_xla():
    """pol = (): no reference stack; the plain form on every device."""
    a, _, bounds, lbounds, excl, av, _, sc = make_agg_case(13, 16, 256, 1, 128)
    ja, jbd, jlb, jex, jav, jsc = _j(a, bounds, lbounds, excl, av, sc)
    for op in AGG_OPS:
        c, v = tops.xlevel_agg(T(a), None, (), T(av), None, T(sc), op, T(bounds),
                               lbounds=T(lbounds), excludes=T(excl))
        wc, wv = jops.xlevel_agg(ja, None, (), jav, None, jsc, op=op, bounds=jbd,
                                 backend="xla", lbounds=jlb, excludes=jex)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


def _bad_agg_inputs():
    a = torch.zeros((4, 128), dtype=torch.int32)
    bs = torch.zeros((2, 4, 128), dtype=torch.int32)
    av, bv, sc = torch.zeros((4, 128)), torch.zeros((2, 4, 128)), torch.ones(4)
    return {
        "op": (a, bs, av, bv, sc, "mean"),
        "a_vals dtype": (a, bs, av.double(), bv, sc, "sum"),
        "a_vals shape": (a, bs, av[:, :64].contiguous(), bv, sc, "sum"),
        "b_vals shape": (a, bs, av, bv[:1].contiguous(), sc, "sum"),
        "b_vals non-contiguous": (a, bs, av, torch.zeros((2, 4, 256))[..., ::2], sc, "sum"),
        "scale shape": (a, bs, av, bv, sc[:3], "sum"),
        "scale dtype": (a, bs, av, bv, sc.half(), "sum"),
        "bs dtype": (a, bs.long(), av, bv, sc, "sum"),
    }


@pytest.mark.parametrize("case", sorted(_bad_agg_inputs()))
def test_multi_agg_wrapper_raises_on_what_the_kernel_does_not_take(case):
    a, bs, av, bv, sc, op = _bad_agg_inputs()[case]
    with pytest.raises(ValueError):
        K.intersect_multi_agg(a, bs, (1, 0), av, bv, sc, op)


@pytest.mark.parametrize("op", ("mac", "max", "min"))
@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (256, 384), (640, 128)])
def test_vinter_plain_version_equals_pallas_interpret_and_xla(cap_a, cap_b, op):
    """Dyadic values bit for bit; values in [0.5, 2) within rtol 1e-6 (f32
    row sums in another order); B as one row expanded over the batch."""
    a, va, b, vb = make_vinter_case(cap_a + cap_b, 8, cap_a, cap_b)
    ja, jva, jb, jvb = _j(a, va, b, vb)
    before = SV.vinter.launches
    got = SV.vinter(T(a), T(va), T(b), T(vb), op)
    assert SV.vinter.launches == before and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        vinter_pallas(ja, jva, jb, jvb, op=op, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jbatch.batch_vinter(ja, jva, jb, jvb, op=op)))
    np.testing.assert_array_equal(tops.xvinter(T(a), T(va), T(b), T(vb), op).numpy(),
                                  got.numpy())
    assert got[0].item() > 0
    b1, vb1 = T(b)[:1].expand(8, cap_b), T(vb)[:1].expand(8, cap_b)
    np.testing.assert_array_equal(SV.vinter(T(a), T(va), b1, vb1, op).numpy(), np.asarray(
        jbatch.batch_vinter(ja, jva, jnp.asarray(b1.numpy()), jnp.asarray(vb1.numpy()),
                            op=op)))
    a, va, b, vb = make_vinter_case(cap_a, 8, cap_a, cap_b, dyadic=False)
    np.testing.assert_allclose(SV.vinter(T(a), T(va), T(b), T(vb), op).numpy(), np.asarray(
        jbatch.batch_vinter(*_j(a, va, b, vb), op=op)), rtol=1e-6)


def _bad_vinter_inputs():
    k, v = torch.zeros((4, 128), dtype=torch.int32), torch.zeros((4, 128))
    wide = torch.zeros((4, 256), dtype=torch.int32)
    return {
        "op": (k, v, k, v, "sum"),
        "key dtype": (k.long(), v, k, v, "mac"),
        "value dtype": (k, v.double(), k, v, "mac"),
        "cap": (torch.zeros((4, 100), dtype=torch.int32), torch.zeros((4, 100)), k, v, "mac"),
        "rows": (k, v, k[:3], v[:3], "mac"),
        "values shape": (k, v, wide, v, "mac"),
        "a non-contiguous": (wide[:, ::2], v, k, v, "mac"),
        "b strides differ": (k, v, k[:1].expand(4, 128), v, "mac"),
        "device": (k.to("meta"), v.to("meta"), k.to("meta"), v.to("meta"), "mac"),
    }


@pytest.mark.parametrize("case", sorted(_bad_vinter_inputs()))
def test_vinter_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        SV.vinter(*_bad_vinter_inputs()[case])
