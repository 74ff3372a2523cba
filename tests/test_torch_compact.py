"""The port's compact-rows and bitmap kernels' plain versions, and the ops
over them, against the JAX package's kernels (interpret mode) and plain
versions, bit for bit on seeded numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import batch as jbatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitmap import bitmap_and_count_pallas
from repro.kernels.bitmap import keys_to_bitmap as jkeys_to_bitmap
from repro.kernels.compact import compact_rows_pallas
from repro_torch import kernels as tkernels
from repro_torch.core import batch as tbatch
from repro_torch.core.stream import SENTINEL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bitmap import TW, bitmap_and_count, bitmap_and_count_ref, keys_to_bitmap
from repro_torch.kernels.compact import compact_rows

from _torch_rows import T, make_case, make_rows, offset_view


def compact_case(seed, batch, cap, density):
    """Rows, and a keep mask of the given density that also marks some
    SENTINEL slots (which must not count); row 2 keeps nothing, row 3
    keeps every slot."""
    rng = np.random.default_rng(seed)
    a = make_rows(rng, batch, cap, 4 * cap)
    keep = rng.random((batch, cap)) < density
    keep[2], keep[3] = False, True
    return a, keep


@pytest.mark.parametrize("batch,cap,out_cap,density", [
    (16, 256, 256, 0.3), (16, 256, 64, 0.9), (8, 128, 128, 1.0), (12, 384, 1, 0.5),
    (9, 128, 32, 0.05)])
def test_compact_rows_equals_jax_kernel_and_plain_version(batch, cap, out_cap, density):
    """Counts are not cut at out_cap, rows are; bool and int32 keep masks
    (int32: kept where > 0) give the same."""
    a, keep = compact_case(batch * cap + out_cap, batch, cap, density)
    rows, counts = compact_rows(T(a), T(keep), out_cap)
    jr, jc = compact_rows_pallas(jnp.asarray(a), jnp.asarray(keep), out_cap=out_cap,
                                 interpret=True)
    br, bc = jbatch.batch_compact_rows(jnp.asarray(a), jnp.asarray(keep), out_cap)
    for want_r, want_c in ((jr, jc), (br, bc)):
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    assert counts[2] == 0 and (rows[2] == SENTINEL).all()
    assert counts[3] == (a[3] != SENTINEL).sum()
    ikeep = np.where(keep, np.random.default_rng(1).integers(1, 4, keep.shape), -1)
    r2, c2 = compact_rows(T(a), T(ikeep.astype(np.int32)), out_cap)
    assert torch.equal(r2, rows) and torch.equal(c2, counts)


@pytest.mark.parametrize("batch,cap,out_cap,offset", [
    (6, 1, 1, 0), (7, 3, 2, 1), (9, 5, 8, 0), (8, 127, 64, 3), (5, 130, 130, 1),
    (4, 256, 300, 2)])
def test_compact_rows_at_odd_caps_and_offset_views_equals_jax_kernel(batch, cap, out_cap,
                                                                     offset):
    """Caps that are not multiples of 4 and rows on offset views (the
    kernel's scalar-load path on the card) give the JAX kernel's rows and
    counts, bool and int32 keep masks alike."""
    a, keep = compact_case(batch + cap + offset, batch, cap, 0.5)
    jr, jc = compact_rows_pallas(jnp.asarray(a), jnp.asarray(keep), out_cap=out_cap,
                                 interpret=True)
    ikeep = np.where(keep, 2, 0).astype(np.int32)
    for k in (T(keep), T(ikeep)):
        ta, tk = offset_view(T(a), offset), offset_view(k, offset)
        assert ta.storage_offset() == offset and ta.is_contiguous() and tk.is_contiguous()
        rows, counts = compact_rows(ta, tk, out_cap)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts[2] == 0 and counts[3] == (a[3] != SENTINEL).sum()


def test_compact_rows_equals_masked_sort():
    """The rows and counts of the masked sort the JAX host path uses."""
    a, keep = compact_case(5, 32, 256, 0.4)
    rows, counts = compact_rows(T(a), T(keep), 128)
    masked = torch.where(T(keep) & (T(a) != SENTINEL), T(a), SENTINEL)
    assert torch.equal(rows, torch.sort(masked, dim=1).values[:, :128])
    assert torch.equal(counts, (masked != SENTINEL).sum(dim=1, dtype=torch.int32))


def test_compact_rows_rejects_what_the_kernel_does_not_take():
    a, keep = compact_case(0, 4, 128, 0.5)
    for bad in (dict(out_cap=0), dict(keep=T(keep.astype(np.float32))),
                dict(keep=T(keep[:, :64])), dict(a=T(a.astype(np.int64)))):
        args = dict(a=T(a), keep=T(keep), out_cap=128) | bad
        with pytest.raises(ValueError):
            compact_rows(**args)


def test_compact_indices_scan_equals_jax():
    rng = np.random.default_rng(3)
    for n, p in ((1000, 0.3), (64, 0.0), (64, 1.0), (0, 0.5)):
        ok = rng.random(n) < p
        order, tot = tbatch.compact_indices_scan(T(ok))
        jorder, jtot = jbatch.compact_indices_scan(jnp.asarray(ok))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        assert int(tot) == int(jtot) == ok.sum()


@pytest.mark.parametrize("seed", range(3))
def test_batch_inter_and_sub_equal_jax(seed):
    a, b, bounds, lbounds = make_case(seed, 24, 256, 128)
    for bd, lbd, oc in ((bounds, lbounds, None), (None, None, 64), (bounds, None, 256)):
        args = (T(a), T(b), T(bd))
        jargs = (jnp.asarray(a), jnp.asarray(b), None if bd is None else jnp.asarray(bd))
        jl = None if lbd is None else jnp.asarray(lbd)
        for tf, jf in ((tbatch.batch_inter, jbatch.batch_inter),
                       (tbatch.batch_sub, jbatch.batch_sub)):
            got = tf(*args, out_cap=oc, lbounds=T(lbd))
            want = jf(*jargs, out_cap=oc, lbounds=jl)
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("seed", range(3))
def test_xinter_equals_jax_xla_and_batch_inter(seed):
    a, b, bounds, lbounds = make_case(seed, 24, 256, 128)
    for oc in (None, 64):
        got = tops.xinter(T(a), T(b), T(bounds), out_cap=oc, lbounds=T(lbounds))
        want = jops.xinter(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds), out_cap=oc,
                           backend="xla", lbounds=jnp.asarray(lbounds))
        plain = tbatch.batch_inter(T(a), T(b), T(bounds), out_cap=oc, lbounds=T(lbounds))
        for g_, w_, p_ in zip(got, want, plain):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
            assert torch.equal(g_, p_)
        assert got[0].shape == (24, oc or 128)


def bitmap_keys(seed, batch, cap, hi):
    """Sorted key rows over [0, max(hi, 2·cap)) with keys of bit 31 (31,
    63, ...) in row 0 and, in row 1, keys past the bitmap's last word."""
    rng = np.random.default_rng(seed)
    keys = make_rows(rng, batch, cap, max(hi, 2 * cap))
    keys[0] = SENTINEL
    keys[0, :4] = [31, 63, 95, 127]
    keys[1] = SENTINEL
    keys[1, :3] = [5, hi + 40_000, hi + 70_000]
    return keys


@pytest.mark.parametrize("num_bits,hi", [(100, 100), (2000, 1900), (8192, 8192),
                                         (9000, 9000)])
def test_keys_to_bitmap_equals_jax(num_bits, hi):
    """W pads to a multiple of TW; bit 31 is INT32_MIN; keys >= W·32 drop."""
    keys = bitmap_keys(num_bits, 12, 128, hi)
    got = keys_to_bitmap(T(keys), num_bits)
    want = np.asarray(jkeys_to_bitmap(jnp.asarray(keys), num_bits))
    assert got.shape == want.shape and got.shape[1] % TW == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == np.int32(-2**31) and (got[0, 1:4] == np.int32(-2**31)).all()
    assert int(bitmap_and_count_ref(got[1:2], got[1:2])) == 1    # only key 5 stays


@pytest.mark.parametrize("num_bits", [256, 8192, 33000])
def test_bitmap_and_count_equals_jax_kernel_and_sorted_count(num_bits):
    """The popcount of the AND equals the JAX kernel, its jnp version and
    the sorted-row intersection count of the same keys."""
    keys_a = bitmap_keys(num_bits, 16, 256, num_bits)
    keys_b = bitmap_keys(num_bits + 1, 16, 256, num_bits)
    keys_a[1], keys_b[1] = SENTINEL, SENTINEL      # keep rows 1 in range here
    wa, wb = keys_to_bitmap(T(keys_a), num_bits), keys_to_bitmap(T(keys_b), num_bits)
    got = bitmap_and_count(wa, wb)
    ja, jb = jnp.asarray(wa.numpy()), jnp.asarray(wb.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(bitmap_and_count_pallas(ja, jb, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.bitmap_and_count_ref(ja, jb)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.xbitmap_count(ja, jb)))
    assert torch.equal(tops.xbitmap_count(wa, wb), got)
    assert torch.equal(got, tops.xinter_count(T(keys_a), T(keys_b)))
    assert got[0] == 4


def test_bitmap_and_count_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((4, 2 * TW), dtype=torch.int32)
    for a, b in ((w[:, :100].contiguous(), w[:, :100].contiguous()),
                 (w, w[:3]), (w, w.long()), (w[:, ::2], w[:, ::2])):
        with pytest.raises(ValueError):
            bitmap_and_count(a, b)


def test_ref_module_and_package_exports_mirror_jax():
    from repro import kernels as jkernels
    assert tref.__all__ == jref.__all__ and tkernels.__all__ == jkernels.__all__
    assert set(jops.__all__) == set(tops.__all__)
    a, b, bounds, _ = make_case(7, 16, 256, 128)
    ja, jb, jbd = jnp.asarray(a), jnp.asarray(b), jnp.asarray(bounds)
    np.testing.assert_array_equal(tref.intersect_count_ref(T(a), T(b), T(bounds)).numpy(),
                                  np.asarray(jref.intersect_count_ref(ja, jb, jbd)))
    np.testing.assert_array_equal(tref.intersect_mark_ref(T(a), T(b), T(bounds)).numpy(),
                                  np.asarray(jref.intersect_mark_ref(ja, jb, jbd)))
    for g_, w_ in zip(tref.intersect_rows_ref(T(a), T(b), T(bounds), out_cap=64),
                      jref.intersect_rows_ref(ja, jb, jbd, out_cap=64)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
