"""The SUB and general levels' CSR-operand forms against the JAX package.

``intersect_sub_count_csr``, ``intersect_mark_csr``, ``intersect_multi_csr``
and ``intersect_multi_mark_csr`` read their reference rows straight from a
CSR (vertex ids and caps, no gathered matrix). On the CPU they take their
plain versions; those are held bit for bit against the JAX package's
``padded_rows`` + Pallas kernels (interpret mode) and ``ops`` on the same
numpy CSR, at tests/test_torch_rowgather.py's edge cases: degree 0, a hub
row cut at its cap, the last vertex, bound-0 rows, mixed caps per
reference. The engine's SUB and general levels go through them with the
JAX engine's counts and counters in both compaction modes and with
``fused_level`` off, and gather only what still takes padded rows.
tests/test_torch_cuda.py holds the kernels against the plain versions on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import get_dataset as jget_dataset
from repro.graph.csr import padded_rows as jpadded_rows
from repro.kernels import ops as jops
from repro.kernels.intersect import intersect_mark_pallas, intersect_multi_pallas
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.core.stream import SENTINEL
from repro_torch.graph import get_dataset
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops
from repro_torch.mining import engine

from _torch_rows import T
from test_torch_rowgather import G, JG, _case, _ids, _jax_stack

POLS = [(1,), (0,), (1, 0), (0, 0), (1, 1, 0)]
# queries with SUB or general levels on email-eu-core 0.25 (the JAX package's
# counts), and the padded-row gathers of each call of their level-2 expand:
# the fresh base of a SUB or general expand level; an INTER expand level
# (diamond's and paw's) reads its base and reference from the CSR, and no
# count leaf or SUB or general reference gathers
LEVEL_QUERIES = {"three-chain-induced": (138732, 0), "diamond": (151646, 0),
                 "4-cycle": (161630, 1), "paw": (1035535, 0), "4-path": (3252244, 1),
                 "4-star": (1652486, 1)}


def _padded(vs, cap):
    return jpadded_rows(JG, jnp.asarray(vs), cap)[0]


def _excludes(ja):
    keys = np.asarray(ja)[:, 1:3]
    return np.ascontiguousarray(np.where(keys == SENTINEL, -1, keys).astype(np.int32))


@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (256, 128), (128, 384)])
def test_mark_and_sub_count_csr_equal_pallas_interpret(cap_a, cap_b):
    """The INTER mark bounded (the TPU kernel's contract) and unbounded (the
    per-reference mask), the SUB mark (the kernel's bool keep row, window
    inside) and the SUB count leaf (a fresh and a carried base), against the
    mark kernel in interpret mode and the JAX package's SUB window."""
    _, va, vb, bounds, lbounds = _case(cap_a * 3 + cap_b)
    ja, jb = _padded(va, cap_a), _padded(vb, cap_b)
    a = T(np.array(ja))
    for bd, lbd in ((bounds, lbounds), (None, None)):
        jbd = None if bd is None else jnp.asarray(bd)
        jlb = None if lbd is None else jnp.asarray(lbd)
        inter = np.asarray(intersect_mark_pallas(ja, jb, jbd, interpret=True, lbounds=jlb))
        member = np.asarray(intersect_mark_pallas(ja, jb, None, interpret=True))
        sub = (member == 0) & np.asarray(jops._sub_window(ja, jbd, jlb))
        csr = (G.indptr, G.indices)
        got_inter = K.intersect_mark_csr(*csr, a, T(vb), cap_b, bounds=T(bd), lbounds=T(lbd))
        got_sub = K.intersect_mark_csr(*csr, a, T(vb), cap_b, sub=True, bounds=T(bd),
                                       lbounds=T(lbd))
        assert got_inter.dtype == got_sub.dtype == torch.bool
        np.testing.assert_array_equal(got_inter.numpy().astype(np.int32), inter)
        np.testing.assert_array_equal(got_sub.numpy(), sub)
        np.testing.assert_array_equal(tops.xmark_csr(*csr, a, T(vb), cap_b).numpy(),
                                      member > 0)
        want = np.asarray(jops.xsub_count(ja, jb, jbd, backend="pallas", lbounds=jlb))
        for kw in (dict(va=T(va), cap_a=cap_a), dict(a=a)):
            got = tops.xsub_count_csr(*csr, T(vb), cap_b, **kw, bounds=T(bd),
                                      lbounds=T(lbd))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        assert want[1] == 0 and (bd is None or want[4] == 0)      # degree 0; bound 0


@pytest.mark.parametrize("with_excludes", [True, False])
@pytest.mark.parametrize("pol", POLS)
def test_multi_csr_equals_pallas_interpret(pol, with_excludes):
    """Counts (a fresh and a carried base) and the bool mark over a padded
    base, references at mixed caps, against the k-reference kernel in
    interpret mode on the JAX package's gathered and padded stack."""
    rng, va, _, bounds, lbounds = _case(len(pol) * 11 + with_excludes)
    k, batch, cap_a = len(pol), va.shape[0], 128
    vbs = np.stack([_ids(rng, batch)[::-1] if r % 2 else _ids(rng, batch)
                    for r in range(k)]).astype(np.int32)
    caps_b = tuple((128, 256, 384)[r % 3] for r in range(k))
    ja = _padded(va, cap_a)
    excl = _excludes(ja) if with_excludes else None
    want_m, want_c = intersect_multi_pallas(
        ja, _jax_stack(vbs, caps_b, SENTINEL), pol, jnp.asarray(bounds), interpret=True,
        lbounds=jnp.asarray(lbounds), excludes=None if excl is None else jnp.asarray(excl))
    common = dict(bounds=T(bounds), lbounds=T(lbounds), excludes=T(excl))
    csr = (G.indptr, G.indices, T(vbs), caps_b, pol)
    a = T(np.array(ja))
    for kw in (dict(va=T(va), cap_a=cap_a), dict(a=a)):
        got = tops.xlevel_count_csr(*csr, **kw, **common)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_c))
    mark = K.intersect_multi_mark_csr(G.indptr, G.indices, a, T(vbs), caps_b, pol, **common)
    assert mark.dtype == torch.bool and mark.shape == a.shape
    np.testing.assert_array_equal(mark.numpy().astype(np.int32), np.asarray(want_m))
    assert int(want_c[4]) == 0 and not mark[4].any()


COMPACT = ("rows", "counts", "src", "verts", "total", "maxc")


@pytest.mark.parametrize("pol", ["sub"] + POLS)
def test_ops_csr_twins_equal_jax_ops(pol):
    """xsub_count / xsub_compact ("sub": the fused SUB level) and
    xlevel_count / xlevel_compact (every pol, E = 2 excludes) with rows from
    the CSR equal the JAX package's ops on the gathered rows, all six
    compaction outputs included, on a chunk whose tail rows carry bound 0.
    A first INTER reference is the base's own row, so that something
    survives every polarity."""
    rng, va, _, bounds, lbounds = _case(len(pol) * 5 + (pol == "sub"))
    bounds[12:] = 0
    k, batch, cap_a = (1 if pol == "sub" else len(pol)), va.shape[0], 256
    vbs = np.stack([_ids(rng, batch)[::-1] if r % 2 else _ids(rng, batch)
                    for r in range(k)]).astype(np.int32)
    if pol != "sub" and pol[0]:
        vbs[0] = va
    caps_b = tuple((256, 128)[r % 2] for r in range(k))
    ja = _padded(va, cap_a)
    a = T(np.array(ja))
    jbd, jlb = jnp.asarray(bounds), jnp.asarray(lbounds)
    out = dict(out_cap=128, out_items=1024)
    if pol == "sub":
        jb = _padded(vbs[0], caps_b[0])
        got = tops.xsub_compact_csr(G.indptr, G.indices, a, T(vbs[0]), caps_b[0],
                                    T(bounds), **out, lbounds=T(lbounds))
        want = jops.xsub_compact(ja, jb, jbd, **out, backend="xla", lbounds=jlb)
        counts = tops.xsub_count_csr(G.indptr, G.indices, T(vbs[0]), caps_b[0], a=a,
                                     bounds=T(bounds), lbounds=T(lbounds))
        want_counts = jops.xsub_count(ja, jb, jbd, backend="xla", lbounds=jlb)
    else:
        jbs = _jax_stack(vbs, caps_b, SENTINEL)
        excl = _excludes(ja)
        kw = dict(lbounds=T(lbounds), excludes=T(excl))
        jkw = dict(backend="xla", lbounds=jlb, excludes=jnp.asarray(excl))
        got = tops.xlevel_compact_csr(G.indptr, G.indices, a, T(vbs), caps_b, pol,
                                      T(bounds), **out, **kw)
        want = jops.xlevel_compact(ja, jbs, pol, jbd, **out, **jkw)
        counts = tops.xlevel_count_csr(G.indptr, G.indices, T(vbs), caps_b, pol,
                                       va=T(va), cap_a=cap_a, bounds=T(bounds), **kw)
        want_counts = jops.xlevel_count(ja, jbs, pol, jbd, **jkw)
    for name, g, w in zip(COMPACT, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(got[4]) > 0


def test_csr_plain_versions_equal_padded_forms():
    """The CSR forms are the padded forms over padded_rows' gathers, a row
    cut at its cap (the hub) and an empty row (the isolated vertex)."""
    from repro_torch.graph.csr import padded_rows
    rng, va, vb, bounds, lbounds = _case(9)
    a, b = padded_rows(G, T(va), 128)[0], padded_rows(G, T(vb), 256)[0]
    assert (a[0] != SENTINEL).all() and (a[1] == SENTINEL).all()
    csr = (G.indptr, G.indices)
    got = K.intersect_mark_csr(*csr, a, T(vb), 256, bounds=T(bounds), lbounds=T(lbounds))
    assert torch.equal(got, K.intersect_mark(a, b, T(bounds), T(lbounds)) > 0)
    assert torch.equal(K.intersect_sub_count_csr(*csr, T(vb), 256, va=T(va), cap_a=128,
                                                 bounds=T(bounds)),
                       tops.xsub_count(a, b, T(bounds)))
    vbs = np.stack([vb, _ids(rng, vb.shape[0])]).astype(np.int32)
    bs = torch.stack([b, torch.nn.functional.pad(padded_rows(G, T(vbs[1]), 128)[0],
                                                 (0, 128), value=SENTINEL)])
    for pol in ((1, 0), (0, 0)):
        mark, counts = K.intersect_multi(a, bs, pol, T(bounds), T(lbounds))
        args = (*csr, T(vbs), (256, 128), pol)
        assert torch.equal(K.intersect_multi_csr(*args, va=T(va), cap_a=128,
                                                 bounds=T(bounds), lbounds=T(lbounds)),
                           counts)
        assert torch.equal(K.intersect_multi_mark_csr(*csr, a, T(vbs), (256, 128), pol,
                                                       T(bounds), T(lbounds)), mark > 0)


def test_level_csr_wrappers_count_launches_only_on_the_card():
    _, va, vb, _, _ = _case(5)
    a = engine.padded_rows(G, T(va), 128)[0]
    before = (K.intersect_mark.launches, K.intersect_multi.launches)
    csr = (G.indptr, G.indices)
    K.intersect_mark_csr(*csr, a, T(vb), 128, sub=True)
    K.intersect_sub_count_csr(*csr, T(vb), 128, va=T(va), cap_a=128)
    K.intersect_multi_csr(*csr, T(vb)[None], (128,), (0,), a=a)
    K.intersect_multi_mark_csr(*csr, a, T(vb)[None], (128,), (1,))
    assert (K.intersect_mark.launches, K.intersect_multi.launches) == before


def _bad_calls():
    vb = torch.arange(4, dtype=torch.int32)
    a = torch.full((4, 128), SENTINEL, dtype=torch.int32)
    ip, ix = G.indptr, G.indices
    vbs = torch.stack([vb, vb])
    mark, sub_count = K.intersect_mark_csr, K.intersect_sub_count_csr
    multi, multi_mark = K.intersect_multi_csr, K.intersect_multi_mark_csr
    return {
        "mark: no base": lambda: mark(ip, ix, None, vb, 128),
        "mark: base rows differ": lambda: mark(ip, ix, a[:3], vb, 128),
        "mark: cap 0": lambda: mark(ip, ix, a, vb, 0),
        "mark: int64 ids": lambda: mark(ip, ix, a, vb.long(), 128),
        "mark: a not 128-wide": lambda: mark(ip, ix, a[:, :100].contiguous(), vb, 128),
        "mark: short bounds": lambda: mark(ip, ix, a, vb, 128,
                                           bounds=torch.zeros(3, dtype=torch.int32)),
        "sub count: both bases": lambda: sub_count(ip, ix, vb, 128, a=a, va=vb, cap_a=128),
        "sub count: va without cap": lambda: sub_count(ip, ix, vb, 128, va=vb),
        "multi: caps != k": lambda: multi(ip, ix, vbs, (128,), (1, 0), a=a),
        "multi: SUB first": lambda: multi(ip, ix, vbs, (128, 128), (0, 1), a=a),
        "multi: nine refs": lambda: multi(ip, ix, vb[None].expand(9, 4).contiguous(),
                                          (128,) * 9, (1,) * 9, a=a),
        "multi: no base": lambda: multi(ip, ix, vbs, (128, 128), (1, 0)),
        "multi: 1-D excludes": lambda: multi(ip, ix, vbs, (128, 128), (1, 0), a=a,
                                             excludes=vb),
        "multi mark: csr base": lambda: multi_mark(ip, ix, None, vbs, (128, 128), (1, 0)),
        "multi mark: float caps": lambda: multi_mark(ip, ix, a, vbs, (128.0, 128), (1, 0)),
        "multi mark: 1-D ids": lambda: multi_mark(ip, ix, a, vb, (128,), (1,)),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_level_csr_wrappers_raise_on_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def _counters(m) -> dict:
    st = dict(m.stats["runner"])
    out = {k: st[k] for k in ("exec_misses", "exec_hits", "items", "device_compactions",
                              "host_compactions", "level_kernel_dispatches", "host_syncs")}
    out["feed_chunks"] = m.metrics.counter("feed_chunks").value
    return out


@pytest.mark.parametrize("config", [{}, {"fused_level": False}, {"device_compact": False}])
def test_sub_and_general_levels_equal_jax_engine(monkeypatch, config):
    """Counts, runner counters and level executions equal the JAX engine's;
    three-chain-induced, diamond and paw gather no padded rows on the device
    path, the others exactly their level-2 expand's fresh base; on the host
    path (masks read every reference from the CSR) each level-2 expand
    gathers its fresh base."""
    tm = Miner(get_dataset("email-eu-core", 0.25), device="cpu", **config)
    jm = JMiner(jget_dataset("email-eu-core", 0.25), backend="xla", **config)
    calls = []
    gather = engine.padded_rows
    monkeypatch.setattr(engine, "padded_rows", lambda *a, **kw: calls.append(1) or gather(*a, **kw))
    for query, (want, per_call) in LEVEL_QUERIES.items():
        del calls[:]
        execs = dict(tm.runner.level_execs)
        assert tm.count(query) == jm.count(query) == want, query
        assert _counters(tm) == _counters(jm), query
        assert tm.runner.level_execs == jm.runner.level_execs, query
        if config.get("fused_level") is False:
            continue        # a general level's masks read a padded base
        level2 = tm.runner.level_execs.get(("expand", 2), 0) - execs.get(("expand", 2), 0)
        if config.get("device_compact") is False:
            per_call = 1 if query != "three-chain-induced" else 0
        assert len(calls) == per_call * level2, (query, len(calls), level2)
