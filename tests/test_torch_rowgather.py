"""The count and aggregate leaves' CSR-operand forms against the JAX package.

``intersect_count_csr`` and ``intersect_multi_agg_csr`` read their rows
straight from a CSR (vertex ids and caps, no gathered matrix). On the CPU
they take their plain versions; those are held bit for bit against the JAX
package's ``padded_rows`` + Pallas kernels (interpret mode) on the same
numpy CSR, at its edge cases: degree 0, degree above the cap (the row is
cut), the last vertex, bound-0 rows, a carried base with no values (1.0).
The engine's triangle, 4-clique and weighted T / 4C / paw leaves go through
them with the JAX engine's counts, aggregates and counters, and gather no
padded rows. tests/test_torch_cuda.py holds the kernels against the plain
versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import get_dataset as jget_dataset
from repro.graph import with_edge_values as jwith_edge_values
from repro.graph.csr import build_csr as jbuild_csr
from repro.graph.csr import edge_list as jedge_list
from repro.graph.csr import padded_rows as jpadded_rows
from repro.graph.csr import padded_value_rows as jpadded_value_rows
from repro.kernels.intersect import intersect_count_pallas, intersect_multi_agg_pallas
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.core.stream import SENTINEL
from repro_torch.graph import edge_list, edge_weights, get_dataset, with_edge_values
from repro_torch.graph.csr import build_csr
from repro_torch.kernels import intersect as K
from repro_torch.kernels import ops as tops
from repro_torch.mining import engine

from _torch_rows import T, make_bounds, make_values

V = 300
HUB = 7          # degree above both caps below: its rows are cut
LONELY = 11      # degree 0


def _graph():
    """A seeded graph with a hub past the caps, an isolated vertex, and
    dyadic edge values; the same edges and values for both packages."""
    rng = np.random.default_rng(0)
    edges = rng.integers(0, V, size=(2400, 2))
    edges = np.concatenate([edges, np.stack([np.full(290, HUB), rng.choice(V, 290,
                                                                         replace=False)], 1)])
    edges = edges[(edges[:, 0] != LONELY) & (edges[:, 1] != LONELY)]
    edges = np.concatenate([edges, [[V - 1, 3], [V - 1, HUB]]])
    tg, jg = build_csr(edges, V), jbuild_csr(edges, V)
    w = make_values(rng, (tg.num_edges,))
    return with_edge_values(tg, w), jwith_edge_values(jg, w)


G, JG = _graph()


def _ids(rng, batch):
    """Vertex ids with the edge cases in the first rows: the hub, the
    isolated vertex, the last vertex."""
    vs = rng.integers(0, V, size=batch).astype(np.int32)
    vs[:3] = [HUB, LONELY, V - 1]
    return vs


def _case(seed, batch=16):
    rng = np.random.default_rng(seed)
    va, vb = _ids(rng, batch), _ids(rng, batch)[::-1].copy()
    bounds, lbounds = make_bounds(rng, batch, V)
    bounds[4] = 0                                       # a dead row
    return rng, va, vb, bounds, lbounds


def test_graph_has_the_edge_cases():
    deg = G.degrees.numpy()
    assert deg[HUB] > 256 and deg[LONELY] == 0 and deg[V - 1] >= 2


@pytest.mark.parametrize("cap_a,cap_b", [(128, 128), (256, 128), (128, 384)])
def test_count_csr_equals_pallas_interpret(cap_a, cap_b):
    _, va, vb, bounds, lbounds = _case(cap_a + cap_b)
    ja = jpadded_rows(JG, jnp.asarray(va), cap_a)[0]
    jb = jpadded_rows(JG, jnp.asarray(vb), cap_b)[0]
    for bd, lbd in ((bounds, lbounds), (None, None)):
        want = np.asarray(intersect_count_pallas(
            ja, jb, None if bd is None else jnp.asarray(bd), interpret=True,
            lbounds=None if lbd is None else jnp.asarray(lbd)))
        got = K.intersect_count_csr(G.indptr, G.indices, T(vb), cap_b, va=T(va),
                                    cap_a=cap_a, bounds=T(bd), lbounds=T(lbd))
        # the carried-base form: A as padded rows, B from the CSR
        got_pad = tops.xinter_count_csr(G.indptr, G.indices, T(vb), cap_b,
                                        a=T(np.array(ja)), bounds=T(bd), lbounds=T(lbd))
        assert got.dtype == got_pad.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_pad.numpy(), want)
        assert want[1] == 0 and (bd is None or want[4] == 0)   # degree 0; bound 0


def _jax_stack(vs, caps, fill, value_rows=False):
    rows = [(jpadded_value_rows if value_rows else
             lambda g, v, c: jpadded_rows(g, v, c)[0])(JG, jnp.asarray(v), c)
            for v, c in zip(vs, caps)]
    capmax = max(caps)
    return jnp.stack([jnp.pad(r, ((0, 0), (0, capmax - r.shape[1])),
                              constant_values=fill) for r in rows])


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("pol,caps_b", [((1,), (128,)), ((1, 0), (256, 128)),
                                        ((1, 1, 0), (128, 256, 128))])
def test_multi_agg_csr_equals_pallas_interpret(pol, caps_b, op):
    """Dyadic values: counts and vals bit for bit, the base fresh (its own
    CSR values) and carried (a_vals None: 1.0), with excludes."""
    rng, va, _, bounds, lbounds = _case(len(pol) * 7 + len(op))
    k, batch, cap_a = len(pol), va.shape[0], 128
    vbs = np.stack([_ids(rng, batch)[::-1] if r else _ids(rng, batch)
                    for r in range(k)]).astype(np.int32)
    ja = jpadded_rows(JG, jnp.asarray(va), cap_a)[0]
    jav = jpadded_value_rows(JG, jnp.asarray(va), cap_a)
    jbs = _jax_stack(vbs, caps_b, SENTINEL)
    jbv = _jax_stack(vbs, caps_b, 0.0, value_rows=True)
    keys = np.asarray(ja)[:, 1:3]
    excl = np.ascontiguousarray(np.where(keys == SENTINEL, -1, keys).astype(np.int32))
    scale = make_values(rng, (batch,))
    common = dict(bounds=T(bounds), lbounds=T(lbounds), excludes=T(excl))
    for base, a_vals in (("fresh", jav), ("carry", jnp.ones_like(jav))):
        _, want_c, want_v = intersect_multi_agg_pallas(
            ja, jbs, pol, a_vals, jbv, jnp.asarray(scale), op, jnp.asarray(bounds),
            interpret=True, lbounds=jnp.asarray(lbounds), excludes=jnp.asarray(excl))
        kw = dict(va=T(va), cap_a=cap_a) if base == "fresh" else dict(a=T(np.array(ja)))
        got_c, got_v = tops.xlevel_agg_csr(G.indptr, G.indices, G.edge_values, T(vbs),
                                           caps_b, pol, T(scale), op, **kw, **common)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert got_c[4] == 0


def test_csr_plain_versions_equal_padded_forms():
    """The CSR forms are the padded forms over padded_rows' gathers, a row
    cut at its cap (the hub) and an empty row (the isolated vertex)."""
    from repro_torch.graph.csr import padded_rows, padded_value_rows
    _, va, vb, bounds, lbounds = _case(3)
    a, b = padded_rows(G, T(va), 128)[0], padded_rows(G, T(vb), 256)[0]
    assert (a[0] != SENTINEL).all() and (a[1] == SENTINEL).all()
    assert torch.equal(K.intersect_count_csr(G.indptr, G.indices, T(vb), 256, va=T(va),
                                             cap_a=128, bounds=T(bounds)),
                       K.intersect_count(a, b, T(bounds)))
    av, bv = padded_value_rows(G, T(va), 128), padded_value_rows(G, T(vb), 256)
    scale = torch.ones(va.shape[0])
    for op in ("sum", "max"):
        _, c, v = K.intersect_multi_agg(a, b[None], (1,), av, bv[None], scale, op, T(bounds))
        got = K.intersect_multi_agg_csr(G.indptr, G.indices, G.edge_values, T(vb)[None],
                                        (256,), (1,), scale, op, va=T(va), cap_a=128,
                                        bounds=T(bounds))
        assert torch.equal(got[0], c) and torch.equal(got[1], v)


def test_csr_wrappers_count_launches_only_on_the_card():
    _, va, vb, bounds, _ = _case(5)
    n0, n1 = K.intersect_count.launches, K.intersect_multi_agg.launches
    K.intersect_count_csr(G.indptr, G.indices, T(vb), 128, va=T(va), cap_a=128)
    K.intersect_multi_agg_csr(G.indptr, G.indices, G.edge_values, T(vb)[None], (128,),
                              (1,), torch.ones(16), va=T(va), cap_a=128)
    assert (K.intersect_count.launches, K.intersect_multi_agg.launches) == (n0, n1)


def _bad_calls():
    vb, va = torch.arange(4, dtype=torch.int32), torch.arange(4, dtype=torch.int32)
    a = torch.full((4, 128), SENTINEL, dtype=torch.int32)
    ip, ix, ev = G.indptr, G.indices, G.edge_values
    one = torch.ones(4)
    count = K.intersect_count_csr
    agg = K.intersect_multi_agg_csr
    return {
        "both bases": lambda: count(ip, ix, vb, 128, a=a, va=va, cap_a=128),
        "no base": lambda: count(ip, ix, vb, 128),
        "va without cap": lambda: count(ip, ix, vb, 128, va=va),
        "cap not an int": lambda: count(ip, ix, vb, 128.0, va=va, cap_a=128),
        "cap 0": lambda: count(ip, ix, vb, 0, va=va, cap_a=128),
        "int64 ids": lambda: count(ip, ix, vb.long(), 128, va=va, cap_a=128),
        "2-D vb": lambda: count(ip, ix, vb[None], 128, va=va, cap_a=128),
        "rows differ": lambda: count(ip, ix, vb[:3], 128, va=va, cap_a=128),
        "int64 indptr": lambda: count(ip.long(), ix, vb, 128, va=va, cap_a=128),
        "cap_a != a": lambda: count(ip, ix, vb, 128, a=a, cap_a=256),
        "short bounds": lambda: count(ip, ix, vb, 128, va=va, cap_a=128,
                                      bounds=torch.zeros(3, dtype=torch.int32)),
        "a_vals with va": lambda: agg(ip, ix, ev, vb[None], (128,), (1,), one, va=va,
                                      cap_a=128, a_vals=torch.ones(4, 128)),
        "caps != k": lambda: agg(ip, ix, ev, vb[None], (128, 128), (1,), one, a=a),
        "pol SUB first": lambda: agg(ip, ix, ev, torch.stack([vb, vb]), (128, 128),
                                     (0, 1), one, a=a),
        "nine refs": lambda: agg(ip, ix, ev, vb[None].expand(9, 4).contiguous(),
                                 (128,) * 9, (1,) * 9, one, a=a),
        "f64 values": lambda: agg(ip, ix, ev.double(), vb[None], (128,), (1,), one, a=a),
        "f64 scale": lambda: agg(ip, ix, ev, vb[None], (128,), (1,), one.double(), a=a),
        "bad op": lambda: agg(ip, ix, ev, vb[None], (128,), (1,), one, "mean", a=a),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_csr_wrappers_raise_on_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


@pytest.fixture(scope="module")
def miners():
    """(port, JAX) miners on email-eu-core 0.25, unweighted and weighted with
    the same dyadic weights; each pair runs the same queries in the same
    order, so their cumulative counters compare."""
    g, jg = get_dataset("email-eu-core", 0.25), jget_dataset("email-eu-core", 0.25)
    w = edge_weights(edge_list(g), seed=0)
    assert np.array_equal(w, edge_weights(jedge_list(jg), seed=0))
    return {"count": (Miner(g, device="cpu"), JMiner(jg, backend="xla")),
            "weighted": (Miner(with_edge_values(g, w), device="cpu"),
                         JMiner(jwith_edge_values(jg, w), backend="xla"))}


def _counters(m) -> dict:
    st = dict(m.stats["runner"])
    out = {k: st[k] for k in ("exec_misses", "exec_hits", "items", "device_compactions",
                              "level_kernel_dispatches", "host_syncs")}
    for k in ("feed_chunks", "value_lane_dispatches"):
        out[k] = m.metrics.counter(k).value
    return out


def _no_padded_gathers(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the leaf gathered padded rows")
    monkeypatch.setattr(engine, "padded_rows", refuse)
    monkeypatch.setattr(engine, "padded_value_rows", refuse)


def test_count_leaves_equal_jax_engine(miners, monkeypatch):
    """The triangle leaf reads both rows from the CSR, the 4-clique leaf its
    reference (its base is the carried expand survivors)."""
    tm, jm = miners["count"]
    _no_padded_gathers(monkeypatch)
    assert tm.count("triangle") == jm.count("triangle") == 11502
    assert _counters(tm) == _counters(jm)
    monkeypatch.undo()
    assert tm.count("4-clique") == jm.count("4-clique") == 10622
    assert _counters(tm) == _counters(jm)


@pytest.mark.parametrize("query,want", [("triangle", 2835.9375),
                                        ("4-clique", 630.774658203125),
                                        ("paw", 159296.94921875)])
def test_aggregate_leaves_equal_jax_engine(miners, monkeypatch, query, want):
    """Weighted leaves through the no-mark CSR form: the same sums (bit for
    bit: f32 holds every partial) and counters as the JAX engine; the
    weighted triangle gathers no padded rows."""
    tm, jm = miners["weighted"]
    if query == "triangle":
        _no_padded_gathers(monkeypatch)
    assert tm.aggregate(query, "sum") == jm.aggregate(query, "sum") == want
    assert _counters(tm) == _counters(jm)
