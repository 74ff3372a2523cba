"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here is marked ``cuda`` and skips without a CUDA device; run them
on the GPU machine with ``pytest -m cuda tests/test_torch_cuda.py``. The
module imports neither JAX nor the JAX package, which that machine lacks.
"""
import numpy as np
import pytest
import torch

from repro_torch import Miner
from repro_torch.graph import get_dataset
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops

from _torch_rows import T, make_bounds, make_case, make_level_case, make_rows

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
