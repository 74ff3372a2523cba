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

from _torch_rows import T, make_bounds, make_case, make_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,cap_a,cap_b", [
    (64, 128, 128), (8, 384, 640), (32, 2048, 2048), (16, 128, 32768),
    (4, 32768, 16384), (300, 640, 128)])
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
