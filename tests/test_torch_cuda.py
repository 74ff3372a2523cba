"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a CUDA device; run them
on the GPU machine with ``pytest -m cuda tests/test_torch_cuda.py``. The
module imports neither JAX nor the JAX package, which that machine lacks.
"""
import numpy as np
import pytest
import torch

from repro_torch import Miner
from repro_torch.core.stream import SENTINEL
from repro_torch.graph import edge_list, edge_weights, get_dataset, with_edge_values
from repro_torch.kernels import bitmap as BM
from repro_torch.kernels import compact as CP
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels import svinter as SV
from repro_torch.sparse import from_dense, random_csf, spmsp_matmul, ttv

from _torch_rows import (AGG_OPS, AGG_QUERIES, T, make_agg_case, make_bounds, make_case,
                         make_csr, make_level_case, make_rows, make_values,
                         make_vinter_case, offset_view, sum_is_exact)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU machine)")
    return torch.device("cuda")


SHAPES = [(64, 128, 128), (8, 384, 640), (32, 2048, 2048), (16, 128, 32768),
          (4, 32768, 16384), (300, 640, 128)]
POLS = [(1,), (0,), (1, 0), (0, 0), (1, 1, 0)]
NEW_COUNTS = {"three-chain": 138732, "tailed-triangle": 1769583, "diamond": 151646,
              "4-star": 1652486, "4-cycle": 161630, "paw": 1035535, "4-path": 3252244}


@pytest.mark.parametrize("B,cap_a,cap_b", SHAPES)
def test_kernels_equal_plain_versions(cuda, B, cap_a, cap_b):
    """Caps up to 32768 keys take the kernels' global-memory search."""
    rng = np.random.default_rng(B + cap_a + cap_b)
    hi = 2 * max(cap_a, cap_b)
    a = T(make_rows(rng, B, cap_a, hi)).to(cuda)
    b = T(make_rows(rng, B, cap_b, hi)).to(cuda)
    bounds, lbounds = (T(x).to(cuda) for x in make_bounds(rng, B, hi))
    for bd, lbd in ((bounds, lbounds), (bounds, None), (None, lbounds), (None, None)):
        n0, n1 = K.intersect_count.launches, K.intersect_expand.launches
        got_c = K.intersect_count(a, b, bd, lbd)
        got_m, got_mc = K.intersect_expand(a, b, bd, lbd)
        torch.cuda.synchronize()
        assert (K.intersect_count.launches, K.intersect_expand.launches) == (n0 + 1, n1 + 1)
        want_m, want_c = K.intersect_expand_ref(a, b, bd, lbd)
        assert torch.equal(got_c, want_c)
        assert torch.equal(got_m, want_m) and torch.equal(got_mc, want_c)


@pytest.mark.parametrize("B,cap_a,cap_b", SHAPES)
def test_mark_kernel_equals_plain_version(cuda, B, cap_a, cap_b):
    rng = np.random.default_rng(B * cap_a + cap_b)
    hi = 2 * max(cap_a, cap_b)
    a = T(make_rows(rng, B, cap_a, hi)).to(cuda)
    b = T(make_rows(rng, B, cap_b, hi)).to(cuda)
    bounds, lbounds = (T(x).to(cuda) for x in make_bounds(rng, B, hi))
    for bd, lbd in ((bounds, lbounds), (bounds, None), (None, lbounds), (None, None)):
        n = K.intersect_mark.launches
        got = K.intersect_mark(a, b, bd, lbd)
        torch.cuda.synchronize()
        assert K.intersect_mark.launches == n + 1
        assert torch.equal(got, K.intersect_mark_ref(a, b, bd, lbd))


@pytest.mark.parametrize("pol", POLS)
@pytest.mark.parametrize("B,cap_a,cap_b", SHAPES)
def test_multi_kernel_equals_plain_version(cuda, B, cap_a, cap_b, pol):
    """k = 1..3 references, E = 2 excludes holding keys of A, bound-0 rows;
    a stack of 3 x 32768 keys takes the global-memory search."""
    a, bs, bounds, lbounds, excl = (
        T(x).to(cuda) for x in make_level_case(B + cap_a + len(pol), B, cap_a,
                                               len(pol), cap_b))
    for bd, lbd, ex in ((bounds, lbounds, excl), (bounds, None, None),
                        (None, lbounds, excl), (None, None, None)):
        n = K.intersect_multi.launches
        got_m, got_c = K.intersect_multi(a, bs, pol, bd, lbd, ex)
        torch.cuda.synchronize()
        assert K.intersect_multi.launches == n + 1
        want_m, want_c = K.intersect_multi_ref(a, bs, pol, bd, lbd, ex)
        assert torch.equal(got_m, want_m) and torch.equal(got_c, want_c)


def test_level_ops_equal_cpu(cuda):
    a, bs, bounds, lbounds, excl = make_level_case(7, 64, 384, 2, 256)
    bounds[50:] = 0
    args = (T(a), T(bs), (1, 0), T(bounds))
    dev = tuple(x.to(cuda) for x in args[:2]) + ((1, 0), T(bounds).to(cuda))
    for c, d in zip(tops.xlevel_compact(*args, lbounds=T(lbounds), excludes=T(excl)),
                    tops.xlevel_compact(*dev, lbounds=T(lbounds).to(cuda),
                                        excludes=T(excl).to(cuda))):
        assert torch.equal(c, d.cpu())
    for c, d in zip(tops.xsub_compact(T(a), T(bs[0]), T(bounds), lbounds=T(lbounds)),
                    tops.xsub_compact(T(a).to(cuda), T(bs[0]).to(cuda),
                                      T(bounds).to(cuda), lbounds=T(lbounds).to(cuda))):
        assert torch.equal(c, d.cpu())


def test_xinter_compact_equals_cpu(cuda):
    a, b, bounds, lbounds = make_case(3, 64, 384, 256)
    bounds[50:] = 0
    cpu = tops.xinter_compact(T(a), T(b), T(bounds), lbounds=T(lbounds))
    dev = tops.xinter_compact(T(a).to(cuda), T(b).to(cuda), T(bounds).to(cuda),
                              lbounds=T(lbounds).to(cuda))
    for c, d in zip(cpu, dev):
        assert torch.equal(c, d.cpu())


def test_empty_batch_launches_nothing(cuda):
    a = torch.zeros((0, 128), dtype=torch.int32, device=cuda)
    n = K.intersect_count.launches
    assert K.intersect_count(a, a).shape == (0,)
    assert K.intersect_count.launches == n


@pytest.mark.parametrize("chunk", [None, 128])
def test_miner_on_card_equals_miner_on_cpu(cuda, chunk):
    g = get_dataset("email-eu-core", 0.25)
    dev, cpu = Miner(g, chunk=chunk), Miner(g, device="cpu", chunk=chunk)
    n0, n1 = K.intersect_count.launches, K.intersect_expand.launches
    for q in ("triangle", "4-clique", "5-clique", "tailed-triangle", "triangle-nested"):
        assert dev.count(q) == cpu.count(q), q
        assert dev.stats["runner"] == cpu.stats["runner"], q
    st = dev.stats["runner"]
    assert K.intersect_expand.launches - n1 == st["device_compactions"] > 0
    assert K.intersect_count.launches - n0 == \
        st["level_kernel_dispatches"] - st["device_compactions"] > 0


@pytest.mark.parametrize("fused_level", [True, False])
def test_miner_on_card_counts_sub_and_general_levels(cuda, fused_level):
    """The JAX package's counts on email-eu-core 0.25 (benchmarks/
    baseline.json), through the mark and k-reference kernels."""
    g = get_dataset("email-eu-core", 0.25)
    dev = Miner(g, fused_level=fused_level)
    cpu = Miner(g, device="cpu", fused_level=fused_level)
    kernels = (K.intersect_mark, K.intersect_multi)

    def launches(miner, q):
        before = [k.launches for k in kernels]
        got = miner.count(q)
        return got, [k.launches - n for k, n in zip(kernels, before)]

    launched = {}
    for q, want in NEW_COUNTS.items():
        got, launched[q] = launches(dev, q)
        assert got == cpu.count(q) == want, q
        assert dev.stats["runner"] == cpu.stats["runner"], q
    assert sum(m for m, _ in launched.values()) > 0
    assert (sum(x for _, x in launched.values()) > 0) == fused_level
    if not fused_level:
        # 4-cycle's count level has k = 2 references: each of its calls
        # launches two marks where the fused run launches one k-reference kernel
        _, (f_mark, f_multi) = launches(Miner(g), "4-cycle")
        assert f_multi > 0
        assert launched["4-cycle"] == [f_mark + 2 * f_multi, 0]


@pytest.mark.parametrize("op", AGG_OPS)
@pytest.mark.parametrize("pol", POLS)
@pytest.mark.parametrize("B,cap_a,cap_b", SHAPES)
def test_multi_agg_kernel_equals_plain_version(cuda, B, cap_a, cap_b, pol, op):
    """Dyadic values: marks, counts and vals bit for bit (every product and
    row sum is exact in f32), with and without bounds and excludes; stacks
    past 4096 keys take the global-memory path."""
    case = make_agg_case(B + cap_a + len(pol), B, cap_a, len(pol), cap_b)
    a, bs, bounds, lbounds, excl, av, bv, sc = (T(x).to(cuda) for x in case)
    for bd, lbd, ex in ((bounds, lbounds, excl), (bounds, None, None),
                        (None, lbounds, excl), (None, None, None)):
        n = K.intersect_multi_agg.launches
        got = K.intersect_multi_agg(a, bs, pol, av, bv, sc, op, bd, lbd, ex)
        torch.cuda.synchronize()
        assert K.intersect_multi_agg.launches == n + 1
        want = K.intersect_multi_agg_ref(a, bs, pol, av, bv, sc, op, bd, lbd, ex)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("op", AGG_OPS)
@pytest.mark.parametrize("B,cap_a,cap_b", SHAPES)
def test_multi_agg_kernel_non_dyadic_values(cuda, B, cap_a, cap_b, op):
    """Values in [0.5, 2): marks, counts, max and min bit for bit (one
    multiplication order in both); sums within rtol 1e-6, since f32 sums
    of up to cap_a positive terms in two orders may round differently."""
    pol = (1, 1, 0)
    case = make_agg_case(B + cap_b, B, cap_a, 3, cap_b, dyadic=False)
    a, bs, bounds, lbounds, excl, av, bv, sc = (T(x).to(cuda) for x in case)
    got = K.intersect_multi_agg(a, bs, pol, av, bv, sc, op, bounds, lbounds, excl)
    want = K.intersect_multi_agg_ref(a, bs, pol, av, bv, sc, op, bounds, lbounds, excl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if op == "sum":
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    else:
        assert torch.equal(got[2], want[2])


VINTER_SHAPES = [(4096, 128, 128), (512, 128, 256), (64, 2048, 2048), (7, 384, 640)]


@pytest.mark.parametrize("op", ("mac", "max", "min"))
@pytest.mark.parametrize("B,cap_a,cap_b", VINTER_SHAPES)
def test_vinter_kernel_equals_plain_version(cuda, B, cap_a, cap_b, op):
    """Dyadic values bit for bit; values in [0.5, 2) within rtol 1e-6 (f32
    row sums in two orders); B as one row expanded over the batch (row
    stride 0, ttv's vector) too."""
    a, va, b, vb = (T(x).to(cuda) for x in make_vinter_case(B + cap_a, B, cap_a, cap_b))
    n = SV.vinter.launches
    got = SV.vinter(a, va, b, vb, op)
    torch.cuda.synchronize()
    assert SV.vinter.launches == n + 1
    assert torch.equal(got, SV.vinter_ref(a, va, b, vb, op))
    b1, vb1 = b[:1].expand(B, cap_b), vb[:1].expand(B, cap_b)
    assert torch.equal(SV.vinter(a, va, b1, vb1, op), SV.vinter_ref(a, va, b1, vb1, op))
    a, va, b, vb = (T(x).to(cuda) for x in make_vinter_case(B, B, cap_a, cap_b, dyadic=False))
    torch.testing.assert_close(SV.vinter(a, va, b, vb, op), SV.vinter_ref(a, va, b, vb, op),
                               rtol=1e-6, atol=0)


def test_miner_aggregate_on_card_equals_cpu(cuda):
    """The nine weighted queries on email-eu-core 0.25: max and min, and
    sums that f32 holds exactly, bit for bit; other sums within rtol 1e-6
    (chunk partials summed in another order); one value-lane launch per
    aggregate-leaf call with references, none for tailed-triangle's."""
    g = get_dataset("email-eu-core", 0.25)
    g = with_edge_values(g, edge_weights(edge_list(g), seed=0))
    dev, cpu = Miner(g), Miner(g, device="cpu")
    lanes = dev.metrics.counter("value_lane_dispatches")
    for q, n_edges in AGG_QUERIES.items():
        for op in AGG_OPS:
            n, v = K.intersect_multi_agg.launches, lanes.value
            got, want = dev.aggregate(q, op), cpu.aggregate(q, op)
            if op != "sum" or sum_is_exact(want, n_edges):
                assert got == want, (q, op)
            else:
                assert got == pytest.approx(want, rel=1e-6), (q, op)
            assert dev.stats["runner"] == cpu.stats["runner"], (q, op)
            calls = lanes.value - v
            assert calls > 0
            assert K.intersect_multi_agg.launches - n == (0 if q == "tailed-triangle"
                                                          else calls), (q, op)


def test_sparse_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    a_d = np.where(rng.random((90, 70)) < 0.1, rng.normal(size=(90, 70)), 0).astype(np.float32)
    b_d = np.where(rng.random((70, 80)) < 0.1, rng.normal(size=(70, 80)), 0).astype(np.float32)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    n, n_pairs = SV.vinter_grid.launches, SV.vinter.launches
    c = spmsp_matmul(a, b, row_block=16, col_block=16)
    rows, cols = int((a_d != 0).any(1).sum()), int((b_d != 0).any(0).sum())
    assert SV.vinter_grid.launches - n == -(-rows // 16) * -(-cols // 16)
    assert SV.vinter.launches == n_pairs          # spmm forms no pairs
    np.testing.assert_allclose(c, spmsp_matmul(a, b, 16, 16, device="cpu"), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c, a_d.astype(np.float64) @ b_d, rtol=1e-5, atol=1e-6)
    t = random_csf((20, 9, 40), 700, seed=2)
    keys = np.arange(40, dtype=np.int32)
    vals = rng.normal(size=40).astype(np.float32)
    got, want = ttv(t, keys, vals, fiber_block=64)[2], ttv(t, keys, vals, 64, device="cpu")[2]
    assert SV.vinter.launches - n_pairs == -(-t.num_fibers // 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,cap,out_cap,density", [
    (64, 128, 128, 0.3), (32, 2048, 2048, 0.05), (32, 2048, 2048, 1.0),
    (300, 256, 64, 0.9), (5, 640, 1, 0.5), (7, 33, 17, 0.6)])
def test_compact_rows_kernel_equals_plain_version(cuda, B, cap, out_cap, density):
    """Rows cut at out_cap, counts not; all-dead rows; keep set on
    SENTINEL slots; bool and int32 keep masks; caps not a multiple of 128."""
    rng = np.random.default_rng(B + cap + out_cap)
    a = make_rows(rng, B, cap, 4 * cap)
    keep = rng.random((B, cap)) < density
    keep[1] = False
    for k in (keep, np.where(keep, 2, -1).astype(np.int32)):
        n = CP.compact_rows.launches
        got = CP.compact_rows(T(a).to(cuda), T(k).to(cuda), out_cap)
        torch.cuda.synchronize()
        assert CP.compact_rows.launches == n + 1
        want = CP.compact_rows_ref(T(a), T(k), out_cap)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert got[1][1] == 0 and (got[0][1] == SENTINEL).all()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("team", ["warp", "block"])
@pytest.mark.parametrize("cap", [1, 3, 127, 128, 2048])
def test_compact_rows_kernel_on_every_path(cuda, monkeypatch, cap, team, offset):
    """Each team (forced by the wrapper's switch) and each load path (16-byte
    loads; scalar loads at caps not a multiple of 4 and on offset views),
    bool and int32 keep, keep set on SENTINEL slots, all-dead rows, and
    out_cap below, equal to and above the most kept."""
    monkeypatch.setattr(CP, "WARP_MAX_CAP", 1 << 30 if team == "warp" else 0)
    B = 67
    rng = np.random.default_rng(cap + offset)
    a = make_rows(rng, B, cap, 4 * cap + 4)
    keep = rng.random((B, cap)) < 0.6
    keep[1] = False                        # an all-dead row
    keep[2] = True                         # every slot, SENTINEL ones too
    a[3] = SENTINEL
    keep[3] = True                         # no key, every flag set
    for k in (keep, np.where(keep, 5, -2).astype(np.int32)):
        kmax = int(CP.compact_rows_ref(T(a), T(k), cap)[1].max())
        for out_cap in sorted({max(1, kmax // 2), max(1, kmax), kmax + 3}):
            ta, tk = offset_view(T(a).to(cuda), offset), offset_view(T(k).to(cuda), offset)
            n = CP.compact_rows.launches
            got = CP.compact_rows(ta, tk, out_cap)
            torch.cuda.synchronize()
            assert CP.compact_rows.launches == n + 1
            want = CP.compact_rows_ref(T(a), T(k), out_cap)
            assert torch.equal(got[0].cpu(), want[0]), (out_cap, k.dtype)
            assert torch.equal(got[1].cpu(), want[1]), (out_cap, k.dtype)
            assert got[1][1] == 0 and got[1][3] == 0 and (got[0][1] == SENTINEL).all()


@pytest.mark.parametrize("op", ("mac", "max", "min"))
@pytest.mark.parametrize("B,cap_a,cap_b", [(333, 128, 128), (100, 256, 640), (64, 512, 2048),
                                           (9, 256, 8192), (5, 128, 16384)])
def test_vinter_kernel_staging_paths(cuda, B, cap_a, cap_b, op):
    """Short A rows (cap_a 128: one key a lane) and longer ones (four keys
    a lane in lockstep, over one and several 128-slot groups), B's row
    searched where it lies, its own a pair or one row at row stride 0, up
    to caps past shared memory (8192, 16384); empty rows on both sides.
    Dyadic values bit for bit, values in [0.5, 2) within rtol 1e-6."""
    for dyadic in (True, False):
        a, va, b, vb = make_vinter_case(B + cap_a + cap_b, B, cap_a, cap_b, dyadic=dyadic)
        a[1], va[1], b[2], vb[2] = SENTINEL, 0, SENTINEL, 0
        a, va, b, vb = (T(x).to(cuda) for x in (a, va, b, vb))
        for bk, bv in ((b, vb), (b[:1].expand(B, cap_b), vb[:1].expand(B, cap_b)),
                       (b[2:3].expand(B, cap_b), vb[2:3].expand(B, cap_b))):
            n = SV.vinter.launches
            got = SV.vinter(a, va, bk, bv, op)
            torch.cuda.synchronize()
            assert SV.vinter.launches == n + 1
            want = SV.vinter_ref(a, va, bk, bv, op)
            if dyadic:
                assert torch.equal(got, want), bk.stride()
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            assert got[1] == 0


@pytest.mark.parametrize("op", ("mac", "max", "min"))
@pytest.mark.parametrize("nr,nc,cap_a,cap_b", [(13, 11, 128, 128), (29, 7, 256, 256),
                                               (5, 9, 2048, 2048), (6, 3, 128, 2048),
                                               (3, 5, 8192, 8192), (2, 3, 32768, 32768)])
def test_vinter_grid_kernel_equals_plain_version(cuda, nr, nc, cap_a, cap_b, op):
    """nr and nc not multiples of the kernel's block of 4 pairs, nor of
    each other; cap_a 128 on the short-row kernel, longer rows (caps 256 to
    32768) on the four-keys-a-lane one; empty rows. Dyadic values bit for
    bit, values in [0.5, 2) within rtol 1e-6."""
    for dyadic in (True, False):
        a, va, _, _ = make_vinter_case(nr + cap_a, nr, cap_a, cap_b, dyadic=dyadic)
        _, _, b, vb = make_vinter_case(nc + cap_b, nc, cap_a, cap_b, dyadic=dyadic)
        a[1], va[1], b[-1], vb[-1] = SENTINEL, 0, SENTINEL, 0
        a, va, b, vb = (T(x).to(cuda) for x in (a, va, b, vb))
        n, n_pairs = SV.vinter_grid.launches, SV.vinter.launches
        got = SV.vinter_grid(a, va, b, vb, op)
        torch.cuda.synchronize()
        assert (SV.vinter_grid.launches, SV.vinter.launches) == (n + 1, n_pairs)
        want = SV.vinter_grid_ref(a, va, b, vb, op)
        assert got.shape == (nr, nc)
        if dyadic:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        assert (got[1] == 0).all() and (got[:, -1] == 0).all()


@pytest.mark.parametrize("cap_a", [128, 256])
def test_vinter_grid_kernel_takes_b_off_a_16_byte_boundary(cuda, cap_a):
    """The grid form loads A 16 bytes at a time but B a key at a time: a B
    stack at a storage offset gives the plain version's sums bit for bit,
    and an A stack there raises before any launch."""
    a, va, b, vb = (T(x).to(cuda) for x in make_vinter_case(cap_a, 21, cap_a, 256))
    ob, ovb = offset_view(b, 1), offset_view(vb, 3)
    n = SV.vinter_grid.launches
    got = SV.vinter_grid(a, va, ob, ovb)
    torch.cuda.synchronize()
    assert SV.vinter_grid.launches == n + 1
    assert torch.equal(got, SV.vinter_grid_ref(a, va, b, vb))
    with pytest.raises(ValueError):
        SV.vinter_grid(offset_view(a, 1), va, b, vb)
    assert SV.vinter_grid.launches == n + 1


@pytest.mark.parametrize("B,words", [(128, 256), (2048, 3072), (64, 32768)])
def test_bitmap_kernel_equals_plain_version(cuda, B, words):
    gen = torch.Generator(device=cuda).manual_seed(B + words)
    a = torch.randint(-2**31, 2**31 - 1, (B, words), generator=gen, device=cuda,
                      dtype=torch.int32)
    b = torch.randint(-2**31, 2**31 - 1, (B, words), generator=gen, device=cuda,
                      dtype=torch.int32)
    a[0] = -1                                      # every bit, bit 31 too
    n = BM.bitmap_and_count.launches
    got = BM.bitmap_and_count(a, b)
    torch.cuda.synchronize()
    assert BM.bitmap_and_count.launches == n + 1
    assert torch.equal(got.cpu(), BM.bitmap_and_count_ref(a.cpu(), b.cpu()))
    assert torch.equal(got, BM.bitmap_and_count_ref(a, b))


def test_bitmap_count_equals_sorted_row_count_on_card(cuda):
    a, b, _, _ = make_case(9, 256, 384, 256)
    ta, tb = T(a).to(cuda), T(b).to(cuda)
    nbits = int(max(a[a != SENTINEL].max(), b[b != SENTINEL].max())) + 1
    got = tops.xbitmap_count(tops.keys_to_bitmap(ta, nbits), tops.keys_to_bitmap(tb, nbits))
    assert torch.equal(got, tops.xinter_count(ta, tb))
    rows, counts = tops.xinter(ta, tb)
    want = tops.xinter(T(a), T(b))
    assert torch.equal(rows.cpu(), want[0]) and torch.equal(counts.cpu(), want[1])


def test_forest_and_host_path_on_card_equal_cpu(cuda):
    """count_many in both modes on the card: counts and counters of the CPU
    run; one compact-rows launch per host compaction."""
    g = get_dataset("email-eu-core", 0.25)
    names = ["4-clique", "diamond", "4-cycle", "paw", "4-path", "4-star"]
    for dc in (True, False):
        dev = Miner(g, device_compact=dc)
        cpu = Miner(g, device="cpu", device_compact=dc)
        n = CP.compact_rows.launches
        assert dev.count_many(names) == cpu.count_many(names) == \
            [10622, 151646, 161630, 1035535, 3252244, 1652486]
        assert dev.stats["runner"] == cpu.stats["runner"]
        assert CP.compact_rows.launches - n == dev.stats["runner"]["host_compactions"]
        assert dev.count_many(["triangle", "three-chain"]) == [11502, 138732]


# the leaves' CSR-operand forms: (B, cap_a, cap_b, cut), each row read at
# cap // cut (cut 2 cuts the rows past half their keys); caps up to 1024 run
# a warp a row, 2048 a block a row, 32768 past shared memory
CSR_SHAPES = [(64, 128, 128, 1), (16, 1024, 1024, 1), (32, 2048, 2048, 1),
              (32, 2048, 2048, 2), (8, 128, 32768, 1)]


def _csr_case(cuda, B, cap_a, cap_b, k, seed):
    """Rows of A and k references as one CSR on the card, values beside
    them, bounds with a dead row, (B, 2) excludes."""
    rng = np.random.default_rng(seed)
    hi = 2 * max(cap_a, cap_b)
    a = make_rows(rng, B, cap_a, hi)
    bs = [make_rows(rng, B, cap_b, hi) for _ in range(k)]
    vals = [np.where(x != SENTINEL, make_values(rng, x.shape), 0).astype(np.float32)
            for x in (a, *bs)]
    indptr, indices, (values,), ids = make_csr([a, *bs], [vals])
    bounds, lbounds = make_bounds(rng, B, hi)
    bounds[1] = 0
    excl = np.where(a[:, :2] == SENTINEL, -1, a[:, :2]).astype(np.int32)
    scale = make_values(rng, (B,))
    on = lambda x: T(np.ascontiguousarray(x)).to(cuda)          # noqa: E731
    return dict(a=on(a), bs=[on(x) for x in bs], a_vals=on(vals[0]), indptr=on(indptr), indices=on(indices),
                values=on(values), va=on(ids[0]), vbs=on(np.stack(ids[1:])),
                bounds=on(bounds), lbounds=on(lbounds), excl=on(excl), scale=on(scale))


@pytest.mark.parametrize("B,cap_a,cap_b,cut", CSR_SHAPES)
def test_count_csr_kernel_equals_plain_version(cuda, B, cap_a, cap_b, cut):
    """A and B from the CSR, and A padded (a carried base): bit for bit
    against the plain version and the padded form on the cut rows; one
    launch a call."""
    c = _csr_case(cuda, B, cap_a, cap_b, 1, B + cap_a + cut)
    ca, cb = cap_a // cut, cap_b // cut
    a_cut, b_cut = c["a"][:, :ca].contiguous(), c["bs"][0][:, :cb].contiguous()
    for bd, lbd in ((c["bounds"], c["lbounds"]), (c["bounds"], None), (None, None)):
        args = (c["indptr"], c["indices"], c["vbs"][0], cb)
        n = K.intersect_count.launches
        got = K.intersect_count_csr(*args, va=c["va"], cap_a=ca, bounds=bd, lbounds=lbd)
        got_pad = K.intersect_count_csr(*args, a=a_cut, bounds=bd, lbounds=lbd)
        torch.cuda.synchronize()
        assert K.intersect_count.launches == n + 2
        want = K.intersect_count_csr_ref(*args, va=c["va"], cap_a=ca, bounds=bd,
                                         lbounds=lbd)
        assert torch.equal(got, want) and torch.equal(got_pad, want)
        assert torch.equal(want, K.intersect_count_ref(a_cut, b_cut, bd, lbd))


@pytest.mark.parametrize("op", AGG_OPS)
@pytest.mark.parametrize("pol", POLS)
@pytest.mark.parametrize("B,cap_a,cap_b,cut", CSR_SHAPES)
def test_multi_agg_csr_kernel_equals_plain_version(cuda, B, cap_a, cap_b, cut, pol, op):
    """The no-mark aggregate leaf, dyadic values: counts and vals bit for
    bit, with a CSR base, a padded base at 1.0 and one with a_vals; odd
    references read at half the cap; one launch a call."""
    c = _csr_case(cuda, B, cap_a, cap_b, len(pol), B + cap_b + len(pol))
    ca, cb = cap_a // cut, cap_b // cut
    caps = tuple(cb if r % 2 == 0 else max(1, cb // 2) for r in range(len(pol)))
    a_cut, av_cut = c["a"][:, :ca].contiguous(), c["a_vals"][:, :ca].contiguous()
    args = (c["indptr"], c["indices"], c["values"], c["vbs"], caps, pol, c["scale"], op)
    for kw in (dict(va=c["va"], cap_a=ca), dict(a=a_cut), dict(a=a_cut, a_vals=av_cut)):
        for bd, lbd, ex in ((c["bounds"], c["lbounds"], c["excl"]), (None, None, None)):
            n = K.intersect_multi_agg.launches
            got = K.intersect_multi_agg_csr(*args, **kw, bounds=bd, lbounds=lbd, excludes=ex)
            torch.cuda.synchronize()
            assert K.intersect_multi_agg.launches == n + 1
            want = K.intersect_multi_agg_csr_ref(*args, **kw, bounds=bd, lbounds=lbd,
                                                 excludes=ex)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,cap_a,cap_b,cut", CSR_SHAPES)
def test_sub_count_and_mark_csr_kernels_equal_plain_versions(cuda, B, cap_a, cap_b, cut):
    """The SUB count leaf (a CSR and a padded base) and the INTER and SUB
    marks over a padded base, B from the CSR: bit for bit, bounds set,
    partly set and None; each one launch on intersect_mark's counter."""
    c = _csr_case(cuda, B, cap_a, cap_b, 1, B + cap_a + 3 * cut)
    ca, cb = cap_a // cut, cap_b // cut
    a_cut = c["a"][:, :ca].contiguous()
    csr = (c["indptr"], c["indices"])
    for bd, lbd in ((c["bounds"], c["lbounds"]), (c["bounds"], None), (None, None)):
        for kw in (dict(va=c["va"], cap_a=ca), dict(a=a_cut)):
            n = K.intersect_mark.launches
            got = K.intersect_sub_count_csr(*csr, c["vbs"][0], cb, **kw, bounds=bd,
                                            lbounds=lbd)
            torch.cuda.synchronize()
            assert K.intersect_mark.launches == n + 1
            assert torch.equal(got, K.intersect_sub_count_csr_ref(
                *csr, c["vbs"][0], cb, **kw, bounds=bd, lbounds=lbd))
        for sub in (False, True):
            n = K.intersect_mark.launches
            got = K.intersect_mark_csr(*csr, a_cut, c["vbs"][0], cb, sub, bd, lbd)
            torch.cuda.synchronize()
            assert K.intersect_mark.launches == n + 1 and got.dtype == torch.bool
            assert torch.equal(got, K.intersect_mark_csr_ref(*csr, a_cut, c["vbs"][0], cb,
                                                             sub, bd, lbd))


@pytest.mark.parametrize("pol", POLS)
@pytest.mark.parametrize("B,cap_a,cap_b,cut", CSR_SHAPES)
def test_multi_csr_kernels_equal_plain_versions(cuda, B, cap_a, cap_b, cut, pol):
    """The general count leaf (a CSR and a padded base) and the general
    expand mark (a padded base), odd references at half the cap, with and
    without bounds and excludes: bit for bit, one launch a call on
    intersect_multi's counter."""
    c = _csr_case(cuda, B, cap_a, cap_b, len(pol), B + cap_b + 7 * len(pol))
    ca, cb = cap_a // cut, cap_b // cut
    caps = tuple(cb if r % 2 == 0 else max(1, cb // 2) for r in range(len(pol)))
    a_cut = c["a"][:, :ca].contiguous()
    csr = (c["indptr"], c["indices"], c["vbs"], caps, pol)
    for bd, lbd, ex in ((c["bounds"], c["lbounds"], c["excl"]), (None, None, None)):
        for kw in (dict(va=c["va"], cap_a=ca), dict(a=a_cut)):
            n = K.intersect_multi.launches
            got = K.intersect_multi_csr(*csr, **kw, bounds=bd, lbounds=lbd, excludes=ex)
            torch.cuda.synchronize()
            assert K.intersect_multi.launches == n + 1
            assert torch.equal(got, K.intersect_multi_csr_ref(*csr, **kw, bounds=bd,
                                                              lbounds=lbd, excludes=ex))
        n = K.intersect_multi.launches
        args = (c["indptr"], c["indices"], a_cut, c["vbs"], caps, pol, bd, lbd, ex)
        got = K.intersect_multi_mark_csr(*args)
        torch.cuda.synchronize()
        assert K.intersect_multi.launches == n + 1 and got.dtype == torch.bool
        assert torch.equal(got, K.intersect_multi_mark_csr_ref(*args))


def test_level_csr_forms_refuse_an_unaligned_base(cuda):
    """The marks read the base 16 bytes at a time: a view starting off a
    16-byte boundary raises before any launch."""
    c = _csr_case(cuda, 8, 128, 128, 1, 0)
    a = torch.full((8 * 128 + 1,), SENTINEL, dtype=torch.int32, device=cuda)[1:].view(8, 128)
    with pytest.raises(ValueError):
        K.intersect_mark_csr(c["indptr"], c["indices"], a, c["vbs"][0], 128)
    with pytest.raises(ValueError):
        K.intersect_multi_mark_csr(c["indptr"], c["indices"], a, c["vbs"], (128,), (1,))


def test_sub_and_general_levels_on_card_gather_no_reference_rows(cuda, monkeypatch):
    """On the card, three-chain-induced and paw (an INTER expand level, then
    a general leaf) gather no padded rows, and 4-cycle only its level-2
    expand's fresh base; the CPU's counts."""
    from repro_torch.mining import engine
    g = get_dataset("email-eu-core", 0.25)
    queries = ("three-chain-induced", "paw", "4-cycle")
    want = {q: Miner(g, device="cpu").count(q) for q in queries}
    calls = []
    gather = engine.padded_rows
    monkeypatch.setattr(engine, "padded_rows",
                        lambda *a, **kw: calls.append(1) or gather(*a, **kw))
    m = Miner(g)
    assert m.count("three-chain-induced") == want["three-chain-induced"] and not calls
    assert m.count("paw") == want["paw"] and not calls
    level2 = m.runner.level_execs[("expand", 2)]
    assert m.count("4-cycle") == want["4-cycle"]
    assert len(calls) == m.runner.level_execs[("expand", 2)] - level2 > 0


def test_leaves_on_card_gather_no_padded_rows(cuda, monkeypatch):
    """The triangle's count leaf and weighted triangle's aggregate leaf read
    their rows from the CSR on the card: no padded_rows gather, the CPU's
    count and sum."""
    from repro_torch.mining import engine
    g = get_dataset("email-eu-core", 0.25)
    wg = with_edge_values(g, edge_weights(edge_list(g), seed=0))

    def refuse(*args, **kwargs):
        raise AssertionError("the leaf gathered padded rows")
    want = (Miner(g, device="cpu").count("triangle"),
            Miner(wg, device="cpu").aggregate("triangle", "sum"))
    monkeypatch.setattr(engine, "padded_rows", refuse)
    monkeypatch.setattr(engine, "padded_value_rows", refuse)
    assert (Miner(g).count("triangle"), Miner(wg).aggregate("triangle", "sum")) == want


@pytest.mark.parametrize("B,cap_a,cap_b,cut", CSR_SHAPES)
def test_expand_csr_and_items_kernels_equal_plain_versions(cuda, B, cap_a, cap_b, cut):
    """The INTER expand level's CSR form (a CSR and a padded base, bounds
    set, partly set and None, out_cap at and above min(cap_a, cap_b)) and
    the items pass (out_items at the rows' size and below the total): bit
    for bit against the plain versions, one launch a call on each counter;
    ops.xinter_compact_csr's six outputs equal the CPU's."""
    c = _csr_case(cuda, B, cap_a, cap_b, 1, B + cap_a + 5 * cut)
    ca, cb = cap_a // cut, cap_b // cut
    a_cut = c["a"][:, :ca].contiguous()
    csr = (c["indptr"], c["indices"], c["vbs"][0], cb)
    for bd, lbd in ((c["bounds"], c["lbounds"]), (c["bounds"], None), (None, None)):
        for kw in (dict(va=c["va"], cap_a=ca), dict(a=a_cut)):
            for out_cap in (min(ca, cb), max(ca, cb) + 5):
                n = K.intersect_expand.launches
                got = K.intersect_expand_csr(*csr, out_cap, **kw, bounds=bd, lbounds=lbd)
                torch.cuda.synchronize()
                assert K.intersect_expand.launches == n + 1
                want = K.intersect_expand_csr_ref(*csr, out_cap, **kw, bounds=bd, lbounds=lbd)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            rows, counts = got
            offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
            total = int(counts.sum())
            for items in (rows.numel(), max(1, total // 2)):
                n = K.expand_items.launches
                got_i = K.expand_items(rows, counts, offs, items)
                torch.cuda.synchronize()
                assert K.expand_items.launches == n + 1
                want_i = K.expand_items_ref(rows, counts, offs, items)
                assert torch.equal(got_i[0], want_i[0]) and torch.equal(got_i[1], want_i[1])
            dev = tops.xinter_compact_csr(*csr, **kw, bounds=bd, lbounds=lbd)
            cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            cpu = tops.xinter_compact_csr(*(x.cpu() for x in csr[:3]), cb, **cpu_kw,
                                          bounds=None if bd is None else bd.cpu(),
                                          lbounds=None if lbd is None else lbd.cpu())
            for d, w in zip(dev, cpu):
                assert torch.equal(d.cpu(), w)


def test_padded_expand_refuses_an_unaligned_base(cuda):
    """The padded expand reads its base 16 bytes at a time: a view starting
    off a 16-byte boundary raises before any launch."""
    a = torch.full((8 * 128 + 1,), SENTINEL, dtype=torch.int32, device=cuda)[1:].view(8, 128)
    b = torch.full((8, 128), SENTINEL, dtype=torch.int32, device=cuda)
    n = K.intersect_expand.launches
    with pytest.raises(ValueError):
        K.intersect_expand(a, b)
    assert K.intersect_expand.launches == n


def test_inter_expand_levels_on_card_gather_no_padded_rows(cuda, monkeypatch):
    """4-clique, 5-clique and diamond read every row from the CSR on the
    card: no padded_rows gather, the CPU's counts and runner counters; one
    expand and one items launch per device compaction."""
    from repro_torch.mining import engine
    g = get_dataset("email-eu-core", 0.25)
    queries = ("4-clique", "5-clique", "diamond")
    cpu = Miner(g, device="cpu")
    want = {q: (cpu.count(q), dict(cpu.stats["runner"])) for q in queries}

    def refuse(*args, **kwargs):
        raise AssertionError("an INTER expand level gathered padded rows")
    monkeypatch.setattr(engine, "padded_rows", refuse)
    m = Miner(g)
    for q in queries:
        n0, n1 = K.intersect_expand.launches, K.expand_items.launches
        c0 = m.stats["runner"]["device_compactions"]
        assert m.count(q) == want[q][0], q
        assert dict(m.stats["runner"]) == want[q][1], q
        calls = m.stats["runner"]["device_compactions"] - c0
        assert K.intersect_expand.launches - n0 == K.expand_items.launches - n1 == calls > 0


@pytest.mark.parametrize("device_compact", [True, False])
def test_embeddings_on_card_equal_cpu(cuda, device_compact):
    """Emit levels on the card, in both modes: the CPU run's rows and
    counters. Device path: each INTER emit call one expand-CSR and one items
    launch, a SUB one a mark, a general one a k-reference launch; host path:
    one compact-rows launch per host compaction."""
    from repro_torch.mining.engine import WaveRunner
    g = get_dataset("email-eu-core", 0.25)
    dev = Miner(g, device_compact=device_compact)
    cpu = Miner(g, device="cpu", device_compact=device_compact)
    shape_kernel = {"inter": K.intersect_expand, "sub": K.intersect_mark,
                    None: K.intersect_multi}
    for q in ("triangle", "4-clique", "diamond", "4-cycle"):
        emit = dev.compile(q, emit=True).ops[-1]
        kernel = shape_kernel[WaveRunner._fused_shape(emit)]
        n0, c0, h0 = kernel.launches, CP.compact_rows.launches, \
            dev.stats["runner"]["host_compactions"]
        calls0 = dev.runner.level_execs.get((emit.kind, emit.level), 0)
        got, want = dev.embeddings(q), cpu.embeddings(q)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and len(got) > 0, q
        assert dev.stats["runner"] == cpu.stats["runner"], q
        calls = dev.runner.level_execs[emit.kind, emit.level] - calls0
        hosted = dev.stats["runner"]["host_compactions"] - h0
        assert CP.compact_rows.launches - c0 == hosted
        if device_compact:
            assert kernel.launches - n0 >= calls > 0 and hosted == 0, q
        else:
            assert hosted >= calls > 0, q


def test_fsm_and_its_feed_on_card_equal_cpu(cuda):
    """The FSM feed through a [count, emit] forest and fsm / sfsm with the
    triangle feed on the card: the CPU run's results."""
    from repro_torch.mining import apps
    from repro_torch.mining.fsm import fsm, random_labels, sfsm
    g = get_dataset("email-eu-core", 0.25)
    dev, cpu = Miner(g), Miner(g, device="cpu")
    plans = [dev.compile("triangle"), *apps.FSM_FEED_PLANS]
    (count, rows), (ccount, crows) = dev.run_plans(plans), cpu.run_plans(plans)
    assert count == ccount == len(rows) == 11502
    np.testing.assert_array_equal(rows, crows)
    labels = random_labels(g.num_vertices, 4, seed=1)
    for fn in (fsm, sfsm):
        assert fn(g, labels, 20, miner=dev) == fn(g, labels, 20, miner=cpu)


def test_traced_dispatch_synchronizes_on_card_only_when_tracing(cuda, monkeypatch):
    """Tracing on: one synchronize per dispatch span; off: none, and the
    same kernel launches either way."""
    from repro_torch.obs import Telemetry
    g = get_dataset("email-eu-core", 0.25)
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a) or real(*a))
    launched = {}
    for traced in (False, True):
        tel = Telemetry(enabled=traced)
        m = Miner(g, telemetry=tel)
        n0 = (K.intersect_count.launches, K.intersect_expand.launches,
              K.intersect_multi.launches)
        del syncs[:]
        got = (m.count("4-clique"), m.count_many(["diamond", "4-cycle"]),
               len(m.embeddings("diamond")))
        launched[traced] = (K.intersect_count.launches - n0[0],
                            K.intersect_expand.launches - n0[1],
                            K.intersect_multi.launches - n0[2], got)
        if traced:
            assert len(syncs) == len(tel.tracer.spans("dispatch")) > 0
        else:
            assert syncs == []
    assert launched[True] == launched[False]


SHARD_QUERIES = ("triangle", "4-clique", "three-chain", "tailed-triangle", "diamond", "paw")


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_miner_on_one_card_equals_unsharded(cuda, shards):
    """S shards on one card (``mesh_devices``): the unsharded card session's
    counts, aggregates and embedding rows (as a multiset), the counters of
    the same mesh on the CPU, and every shard's kernels launched."""
    from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
    g = get_dataset("email-eu-core", 0.25)
    motifs = list(FOUR_MOTIF_SHAPES)
    card = Miner(g, mesh=shards, mesh_devices=("cuda:0",) * shards)
    cpu = Miner(g, device="cpu", mesh=shards)
    one = Miner(g)
    kernels = (K.intersect_count, K.intersect_expand, K.intersect_mark, K.intersect_multi)

    def mix(m):
        return [m.count(q) for q in SHARD_QUERIES] + [m.count_many(motifs)]
    counts = [mix(cpu), mix(one)]
    # the sharded card session's own launches: read just before and after it
    n0 = [k.launches for k in kernels]
    counts.insert(0, mix(card))
    assert all(k.launches > n for k, n in zip(kernels, n0))
    assert counts[0] == counts[1] == counts[2]
    assert card.stats["runner"] == cpu.stats["runner"]
    assert card.stats["runner"]["psum_reductions"] > 0

    def rows(t):
        return t[np.lexsort(t.T[::-1])]
    for q in ("triangle", "diamond", "4-cycle"):
        np.testing.assert_array_equal(rows(card.embeddings(q)), rows(one.embeddings(q)))
    w = with_edge_values(g, edge_weights(edge_list(g), seed=0))
    wcard = Miner(w, mesh=shards, mesh_devices=("cuda:0",) * shards)
    for op in AGG_OPS:
        assert wcard.aggregate("triangle", op) == Miner(w).aggregate("triangle", op)


def test_sharded_mesh_wider_than_the_cards_raises(cuda):
    """Without mesh_devices a mesh takes distinct cards only: one card more
    than the host has raises, naming mesh_devices."""
    g = get_dataset("email-eu-core", 0.25)
    with pytest.raises(ValueError, match="mesh_devices"):
        Miner(g, mesh=torch.cuda.device_count() + 1)


def test_sharded_miner_over_distinct_cards_equals_one_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    g = get_dataset("email-eu-core", 0.25)
    multi = Miner(g, mesh=min(torch.cuda.device_count(), 8))
    assert len(set(multi.mesh.devices)) > 1
    assert [multi.count(q) for q in SHARD_QUERIES] == [Miner(g).count(q) for q in SHARD_QUERIES]
