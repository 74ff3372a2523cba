"""The INTER expand level's CSR form against the JAX package.

``intersect_expand_csr`` reads B's rows (and a fresh base's) straight from a
CSR and packs each row's survivors in the kernel; ``expand_items`` turns
those rows into the level's worklist; ``ops.xinter_compact_csr`` composes
them into the six outputs of ``xinter_compact``'s contract. On the CPU they
take their plain versions; those are held bit for bit against the JAX
package's ``padded_rows`` + ``intersect_expand_pallas`` (interpret mode) +
``batch_compact_scan`` and its ``ops.xinter_compact``, at
tests/test_torch_rowgather.py's edge cases: degree 0, a hub row cut at its
cap, the last vertex, bound-0 rows, lbounds, a fresh and a carried base.
The engine's INTER expand levels (4-clique, 5-clique, diamond, paw) go
through them with the JAX engine's counts, counters and level executions
and gather no padded rows. tests/test_torch_cuda.py holds the kernels
against the plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batch import batch_compact_scan as jbatch_compact_scan
from repro.graph import get_dataset as jget_dataset
from repro.graph.csr import padded_rows as jpadded_rows
from repro.kernels import ops as jops
from repro.kernels.intersect import intersect_expand_pallas
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.core.stream import SENTINEL
from repro_torch.graph import get_dataset
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops
from repro_torch.mining import engine

from _torch_rows import T
from test_torch_levelgather import COMPACT, _counters
from test_torch_rowgather import G, JG, _case

# the INTER-expand queries on email-eu-core 0.25: the JAX package's counts
# (benchmarks/baseline.json)
EXPAND_QUERIES = {"4-clique": 10622, "5-clique": 5051, "diamond": 151646,
                  "paw": 1035535}
FOUR_M = [10622, 151646, 161630, 1035535, 3252244, 1652486]


def _padded(vs, cap):
    return jpadded_rows(JG, jnp.asarray(vs), cap)[0]


def _jax_compact(ja, jb, bounds, lbounds, out_cap, out_items):
    """The JAX package's INTER expand level on gathered rows, twice: its
    ops.xinter_compact (XLA), and the Pallas expand kernel in interpret mode
    with batch_compact_scan on its mark."""
    jbd = None if bounds is None else jnp.asarray(bounds)
    jlb = None if lbounds is None else jnp.asarray(lbounds)
    xla = jops.xinter_compact(ja, jb, jbd, out_cap=out_cap, out_items=out_items,
                              backend="xla", lbounds=jlb)
    mark, counts = intersect_expand_pallas(ja, jb, jbd, interpret=True, lbounds=jlb)
    cap = out_cap or min(ja.shape[1], jb.shape[1])
    scan = jbatch_compact_scan(ja, mark > 0, cap, out_items or ja.shape[0] * cap)
    return xla, scan, counts


@pytest.mark.parametrize("out_cap,out_items", [(None, None), (384, 7)])
@pytest.mark.parametrize("base", ["fresh", "carried"])
@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (256, 128), (128, 384)])
def test_xinter_compact_csr_equals_jax(cap_a, cap_b, base, out_cap, out_items):
    """All six outputs bit for bit, with bounds and lbounds and without;
    out_items 7 drops the items past it. The expand form's rows and counts
    equal the scan's rows and the Pallas kernel's counts."""
    _, va, vb, bounds, lbounds = _case(cap_a * 5 + cap_b + (base == "fresh"))
    ja, jb = _padded(va, cap_a), _padded(vb, cap_b)
    kw = dict(va=T(va), cap_a=cap_a) if base == "fresh" else dict(a=T(np.array(ja)))
    csr = (G.indptr, G.indices, T(vb), cap_b)
    for bd, lbd in ((bounds, lbounds), (None, None)):
        xla, scan, want_counts = _jax_compact(ja, jb, bd, lbd, out_cap, out_items)
        got = tops.xinter_compact_csr(*csr, **kw, bounds=T(bd), out_cap=out_cap,
                                      out_items=out_items, lbounds=T(lbd))
        for name, g, w, w2 in zip(COMPACT, got, xla, scan):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w2), err_msg=name)
        rows, counts = K.intersect_expand_csr(*csr, out_cap or min(cap_a, cap_b), **kw,
                                              bounds=T(bd), lbounds=T(lbd))
        assert torch.equal(rows, got[0]) and torch.equal(counts, got[1])
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
        assert int(counts[1]) == 0 and (rows[1] == SENTINEL).all()     # degree 0
        if bd is not None:
            assert int(counts[4]) == 0 and (rows[4] == SENTINEL).all()  # bound 0
    assert int(got[4]) > 0


@pytest.mark.parametrize("out_items", [None, 5, 4096])
def test_expand_items_plain_version_equals_the_scan(out_items):
    """expand_items' plain version on rows the expand form packed: src and
    verts of the JAX package's batch_compact_scan on the same survivors,
    items past out_items dropped, zeros past the total."""
    _, va, vb, bounds, lbounds = _case(21)
    rows, counts = K.intersect_expand_csr(G.indptr, G.indices, T(vb), 256, 256, va=T(va),
                                          cap_a=256, bounds=T(bounds), lbounds=T(lbounds))
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    items = out_items or rows.numel()
    src, verts = K.expand_items(rows, counts, offs, items)
    keep = np.arange(256)[None] < counts.numpy()[:, None]
    want = jbatch_compact_scan(jnp.asarray(rows.numpy()), jnp.asarray(keep), 256, items)
    np.testing.assert_array_equal(src.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(verts.numpy(), np.asarray(want[3]))
    total = int(counts.sum())
    assert total > 5 and (src[total:] == 0).all() and (verts[total:] == 0).all()


def test_expand_csr_plain_version_equals_padded_form():
    """The CSR form is the padded expand over padded_rows' gathers, then a
    compaction of its mark: a hub row cut at its cap, an empty row."""
    from repro_torch.core.batch import batch_compact_rows
    from repro_torch.graph.csr import padded_rows
    _, va, vb, bounds, lbounds = _case(9)
    a, b = padded_rows(G, T(va), 128)[0], padded_rows(G, T(vb), 256)[0]
    assert (a[0] != SENTINEL).all() and (a[1] == SENTINEL).all()
    mark, counts = K.intersect_expand(a, b, T(bounds), T(lbounds))
    want = batch_compact_rows(a, mark > 0, 128)
    for kw in (dict(va=T(va), cap_a=128), dict(a=a)):
        got = K.intersect_expand_csr(G.indptr, G.indices, T(vb), 256, 128, **kw,
                                     bounds=T(bounds), lbounds=T(lbounds))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], counts)


def test_expand_wrappers_count_launches_only_on_the_card():
    _, va, vb, _, _ = _case(5)
    before = (K.intersect_expand.launches, K.expand_items.launches)
    got = tops.xinter_compact_csr(G.indptr, G.indices, T(vb), 128, va=T(va), cap_a=128)
    K.intersect_expand_csr(G.indptr, G.indices, T(vb), 128, 128,
                           a=engine.padded_rows(G, T(va), 128)[0])
    assert int(got[4]) > 0
    assert (K.intersect_expand.launches, K.expand_items.launches) == before


def _bad_calls():
    vb = torch.arange(4, dtype=torch.int32)
    a = torch.full((4, 128), SENTINEL, dtype=torch.int32)
    ip, ix = G.indptr, G.indices
    expand, items = K.intersect_expand_csr, K.expand_items
    counts = torch.zeros(4, dtype=torch.int32)
    return {
        "expand: out_cap below both caps": lambda: expand(ip, ix, vb, 256, 64, a=a),
        "expand: out_cap below the fresh base's cap": lambda: expand(
            ip, ix, vb, 256, 127, va=vb, cap_a=128),
        "expand: out_cap 0": lambda: expand(ip, ix, vb, 128, 0, a=a),
        "expand: no base": lambda: expand(ip, ix, vb, 128, 128),
        "expand: both bases": lambda: expand(ip, ix, vb, 128, 128, a=a, va=vb, cap_a=128),
        "expand: int64 ids": lambda: expand(ip, ix, vb.long(), 128, 128, a=a),
        "expand: int64 base": lambda: expand(ip, ix, vb, 128, 128, a=a.long()),
        "expand: base not 128-wide": lambda: expand(ip, ix, vb, 128, 128,
                                                    a=a[:, :100].contiguous()),
        "expand: base rows differ": lambda: expand(ip, ix, vb, 128, 128, a=a[:3]),
        "expand: float bounds": lambda: expand(ip, ix, vb, 128, 128, a=a,
                                               bounds=torch.zeros(4)),
        "expand: short lbounds": lambda: expand(ip, ix, vb, 128, 128, a=a,
                                                lbounds=torch.zeros(3, dtype=torch.int32)),
        "expand: int64 indptr": lambda: expand(ip.long(), ix, vb, 128, 128, a=a),
        "items: int64 counts": lambda: items(a, counts.long(), counts, 16),
        "items: short offs": lambda: items(a, counts, counts[:3], 16),
        "items: 1-D rows": lambda: items(a[0], counts, counts, 16),
        "items: out_items 0": lambda: items(a, counts, counts, 0),
        "ops: out_cap below both caps": lambda: tops.xinter_compact_csr(
            ip, ix, vb, 256, a=a, out_cap=64),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_expand_wrappers_raise_on_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


@pytest.fixture(scope="module")
def email():
    return get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)


@pytest.mark.parametrize("config", [{}, {"fused_level": False}])
def test_inter_expand_queries_equal_jax_engine(monkeypatch, email, config):
    """4-clique, 5-clique, diamond and paw: the JAX package's counts, every
    runner counter and level execution equal to the JAX engine's, and no
    padded rows gathered (with fused_level=False, paw's general count leaf
    still gathers its base, one a call: that level's masks take padded
    rows); then the six 4-motifs through count_many, whose forest gathers
    only the fresh bases of its two level-2 nodes that are not INTER."""
    tg, jg = email
    tm = Miner(tg, device="cpu", **config)
    jm = JMiner(jg, backend="xla", **config)
    calls = []
    gather = engine.padded_rows
    monkeypatch.setattr(engine, "padded_rows", lambda *a, **kw: calls.append(1) or gather(*a, **kw))
    for query, want in EXPAND_QUERIES.items():
        del calls[:]
        execs = dict(tm.runner.level_execs)
        assert tm.count(query) == jm.count(query) == want, query
        assert _counters(tm) == _counters(jm), query
        assert tm.runner.level_execs == jm.runner.level_execs, query
        leaf_calls = tm.runner.level_execs.get(("count", 3), 0) - execs.get(("count", 3), 0)
        unfused_leaf = query == "paw" and config.get("fused_level") is False
        assert len(calls) == (leaf_calls if unfused_leaf else 0), (query, len(calls))
    if config:
        return
    del calls[:]
    names = ["4-clique", "diamond", "4-cycle", "paw", "4-path", "4-star"]
    tm, jm = Miner(tg, device="cpu"), JMiner(jg, backend="xla")
    assert tm.count_many(names) == jm.count_many(names) == FOUR_M
    assert _counters(tm) == _counters(jm)
    assert tm.runner.level_execs == jm.runner.level_execs == {("expand", 2): 3,
                                                              ("count", 3): 35}
    assert len(calls) == 2
