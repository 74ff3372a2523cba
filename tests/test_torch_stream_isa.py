"""The port's stream ISA (``repro_torch.core``) against the JAX package's
(``repro.core``) and python-set oracles, on CPU streams.

Counterparts of tests/test_stream_isa.py, with the same strategies: every
property case runs the JAX op on the same numpy streams and demands the
port's keys, length and counts bit-identical to it (values bit-identical on
dyadic values, within rtol 1e-6 otherwise), besides the set semantics and
the invariants I1-I4. Then S_NESTINTER and ``neighbors_stream`` on
tests/test_mining.py's graphs, and the masked-sort worklist oracle
``batch_compact_items`` with the scan compaction held to it item for item.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import isa as jisa
from repro.core import s_nestinter as j_nestinter
from repro.core.batch import batch_compact_items as jbatch_compact_items
from repro.core.stream import make_stream as jmake_stream
from repro.core.stream import round_capacity as jround_capacity
from repro.core.stream import stream_from_slice as jstream_from_slice
from repro.graph import build_csr as jbuild_csr
from repro.graph import neighbors_stream as jneighbors_stream
from repro_torch.core import (LANE, SENTINEL, Stream, StreamTable, empty_stream, isa,
                              make_stream, round_capacity, s_nestinter, stream_from_slice,
                              to_host)
from repro_torch.core.batch import batch_compact_items, batch_compact_scan
from repro_torch.graph import build_csr, neighbors_stream
from repro_torch.graph.generators import clique_planted, erdos_renyi, powerlaw_cluster, rmat

sorted_sets = st.lists(st.integers(0, 10_000), max_size=300).map(
    lambda xs: np.array(sorted(set(xs)), dtype=np.int32))
bounds = st.one_of(st.none(), st.integers(0, 10_000))
# dyadic values: every product and partial sum of a 300-key stream is exact
# in f32, so both packages' sums are exact whatever their order
dyadic = st.lists(st.sampled_from([0.25, 0.5, 0.75, 1.0]), min_size=300, max_size=300)


def check_invariants(s: Stream):
    keys = s.keys.numpy()
    n = int(s.length)
    assert s.capacity % LANE == 0                       # I4
    assert 0 <= n <= s.capacity                         # I3
    assert np.all(keys[n:] == SENTINEL)                 # I2
    if n > 1:
        assert np.all(np.diff(keys[:n]) > 0)            # I1 strictly sorted


def streams(a, b, va=None, vb=None):
    """The same numpy streams in both packages: ((port A, port B), (JAX A, JAX B))."""
    return ((make_stream(a, va, device="cpu"), make_stream(b, vb, device="cpu")),
            (jmake_stream(a, va), jmake_stream(b, vb)))


def assert_same_stream(s: Stream, js) -> None:
    assert s.keys.dtype == torch.int32 and s.length.dtype == torch.int32
    np.testing.assert_array_equal(s.keys.numpy(), np.asarray(js.keys))
    assert int(s.length) == int(js.length)


@settings(max_examples=40, deadline=None)
@given(sorted_sets, sorted_sets, bounds)
def test_inter_matches_set_semantics_and_jax(a, b, bound):
    (sa, sb), (ja, jb) = streams(a, b)
    out = isa.s_inter(sa, sb, bound)
    check_invariants(out)
    assert_same_stream(out, jisa.s_inter(ja, jb, bound))
    want = np.intersect1d(a, b)
    if bound is not None:
        want = want[want < bound]
    np.testing.assert_array_equal(to_host(out), want)
    count = isa.s_inter_c(sa, sb, bound)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(jisa.s_inter_c(ja, jb, bound)) == len(want)


@settings(max_examples=40, deadline=None)
@given(sorted_sets, sorted_sets, bounds)
def test_sub_matches_set_semantics_and_jax(a, b, bound):
    (sa, sb), (ja, jb) = streams(a, b)
    out = isa.s_sub(sa, sb, bound)
    check_invariants(out)
    assert_same_stream(out, jisa.s_sub(ja, jb, bound))
    want = np.setdiff1d(a, b)
    if bound is not None:
        want = want[want < bound]
    np.testing.assert_array_equal(to_host(out), want)
    assert int(isa.s_sub_c(sa, sb, bound)) == int(jisa.s_sub_c(ja, jb, bound)) == len(want)


def test_bound_as_a_tensor():
    (sa, sb), (ja, jb) = streams(np.arange(0, 300, 3, dtype=np.int32),
                                 np.arange(0, 300, 2, dtype=np.int32))
    bound = isa.s_fetch(sb, 40)                         # 80, a 0-d tensor
    assert_same_stream(isa.s_inter(sa, sb, bound), jisa.s_inter(ja, jb, 80))
    assert_same_stream(isa.s_sub(sa, sb, bound), jisa.s_sub(ja, jb, 80))
    assert int(isa.s_inter_c(sa, sb, bound)) == int(jisa.s_inter_c(ja, jb, 80)) == 14


@settings(max_examples=25, deadline=None)
@given(sorted_sets, sorted_sets)
def test_union_identity(a, b):
    (sa, sb), (ja, jb) = streams(a, b)
    got = isa.s_union_count(sa, sb)
    assert int(got) == int(jisa.s_union_count(ja, jb)) == len(np.union1d(a, b))


@settings(max_examples=25, deadline=None)
@given(sorted_sets, sorted_sets)
def test_vinter_mac_is_sparse_dot(a, b):
    va = np.arange(len(a), dtype=np.float32) + 1
    vb = 2.0 * (np.arange(len(b), dtype=np.float32) + 1)
    (sa, sb), (ja, jb) = streams(a, b, va, vb)
    got = isa.s_vinter(sa, sb, op="mac")
    assert got.dtype == torch.float32
    da = dict(zip(a.tolist(), va))
    db = dict(zip(b.tolist(), vb))
    want = sum(da[k] * db[k] for k in set(da) & set(db))
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(got) == pytest.approx(float(jisa.s_vinter(ja, jb, op="mac")), rel=1e-6)


@settings(max_examples=25, deadline=None)
@given(sorted_sets, sorted_sets, dyadic, dyadic)
def test_vinter_ops_bit_identical_on_dyadic_values(a, b, va, vb):
    va, vb = np.float32(va[:len(a)]), np.float32(vb[:len(b)])
    (sa, sb), (ja, jb) = streams(a, b, va, vb)
    for op in isa.VINTER_OPS:
        assert float(isa.s_vinter(sa, sb, op=op)) == float(jisa.s_vinter(ja, jb, op=op))


def test_vinter_max_min():
    (a, b), (ja, jb) = streams([1, 3, 5], [3, 5, 7], [1., 10., 2.], [4., 1., 9.])
    assert float(isa.s_vinter(a, b, op="max")) == 12. == float(jisa.s_vinter(ja, jb, op="max"))
    assert float(isa.s_vinter(a, b, op="min")) == 5. == float(jisa.s_vinter(ja, jb, op="min"))


def test_vinter_requires_values_and_a_known_op():
    a, b = make_stream([1, 2], device="cpu"), make_stream([2, 3], device="cpu")
    with pytest.raises(TypeError):
        isa.s_vinter(a, b)
    with pytest.raises(TypeError):
        jisa.s_vinter(jmake_stream([1, 2]), jmake_stream([2, 3]))
    av = make_stream([1, 2], [1., 1.], device="cpu")
    with pytest.raises(ValueError, match="unknown SVPU op"):
        isa.s_vinter(av, av, op="avg")


def test_fetch_and_eos():
    s, js = make_stream([10, 20, 30], device="cpu"), jmake_stream([10, 20, 30])
    for off in (0, 1, 2, 3, 127, 1000, -1):
        got = isa.s_fetch(s, off)
        assert got.dtype == torch.int32 and int(got) == int(jisa.s_fetch(js, off))
    assert int(isa.s_fetch(s, 1)) == 20
    assert int(isa.s_fetch(s, 3)) == SENTINEL     # EOS
    assert int(isa.s_fetch(s, 1000)) == SENTINEL


def test_stream_from_slice_is_s_read():
    mem = np.arange(0, 100, 2, dtype=np.int32)    # sorted memory
    s = stream_from_slice(torch.from_numpy(mem), 5, 7, capacity=7)
    np.testing.assert_array_equal(to_host(s), mem[5:12])
    check_invariants(s)


@pytest.mark.parametrize("start,length,cap", [(5, 7, 7), (45, 5, 7), (48, 5, 7),
                                              (50, 0, 128), (40, 10, 300), (0, 50, 50)])
def test_stream_from_slice_near_the_end_equals_jax(start, length, cap):
    """A window past the array's end reads SENTINEL there, never its
    neighbour's keys; start and length as ints and as 0-d tensors."""
    mem = np.arange(0, 100, 2, dtype=np.int32)
    want = jstream_from_slice(mem, start, length, cap)
    for st_, ln in ((start, length), (torch.tensor(start), torch.tensor(length))):
        assert_same_stream(stream_from_slice(torch.from_numpy(mem), st_, ln, cap), want)


def test_make_and_empty_stream_equal_jax():
    keys, vals = [2, 3, 5, 8], [0.5, 1.0, 0.25, 0.75]
    for cap in (None, 4, 129):
        s, js = make_stream(keys, vals, cap, device="cpu"), jmake_stream(keys, vals, cap)
        assert_same_stream(s, js)
        np.testing.assert_array_equal(s.values.numpy(), np.asarray(js.values))
        assert s.has_values and s.capacity == js.capacity
    e = empty_stream(200, with_values=True, device="cpu")
    assert e.capacity == 256 and int(e.length) == 0 and bool((e.keys == SENTINEL).all())
    assert e.values.shape == (256,) and not empty_stream(1, device="cpu").has_values


def test_stream_table_smt_semantics():
    t = StreamTable(max_active=2)
    s1 = t.register(make_stream([1], device="cpu"))
    s2 = t.register(make_stream([2], device="cpu"))
    with pytest.raises(RuntimeError):              # stall-on-full
        t.register(make_stream([3], device="cpu"))
    t.release(s1)                                  # S_FREE
    with pytest.raises(KeyError):                  # use-after-free
        t.get(s1)
    t.register(make_stream([4], device="cpu"))     # slot reusable
    assert int(to_host(t.get(s2))[0]) == 2 and len(t) == 2


def test_round_capacity():
    assert round_capacity(0) == LANE
    assert round_capacity(1) == LANE
    assert round_capacity(LANE) == LANE
    assert round_capacity(LANE + 1) == 2 * LANE
    for n in (0, 1, 127, 128, 129, 2012, 4096, 18517):
        assert round_capacity(n) == jround_capacity(n)


# ---------------------------------------------------------------------------
# S_NESTINTER and neighbors_stream on tests/test_mining.py's graphs
# ---------------------------------------------------------------------------


EDGES = {
    "er": (erdos_renyi(150, 700, seed=3), 150),
    "plc": (powerlaw_cluster(120, 4, seed=5), 120),
    "cliq": (clique_planted(90, 260, (6, 5, 5), seed=1), 90),
    "rmat": (rmat(7, 6, seed=2), 128),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_nestinter_equals_jax_and_set_semantics(name):
    """S_NESTINTER(N(v)) == Σ_u∈N(v) |N(v) ∩ N(u)| per the ISA definition
    (with bound_by_key, only common neighbours below u count)."""
    edges, n = EDGES[name]
    g, jg = build_csr(edges, n), jbuild_csr(edges, n)
    deg = g.degrees.numpy()
    for v in (0, 3, 17, int(deg.argmax())):
        s, js = neighbors_stream(g, v), jneighbors_stream(jg, v)
        assert_same_stream(s, js)
        nv = set(to_host(s).tolist())
        for by_key in (False, True):
            got = s_nestinter(g, s, bound_by_key=by_key)
            assert got.dtype == torch.int32 and got.dim() == 0
            want = sum(len({k for k in nv & set(to_host(neighbors_stream(g, u)).tolist())
                            if not by_key or k < u}) for u in nv)
            assert int(got) == int(j_nestinter(jg, js, bound_by_key=by_key)) == want


def test_neighbors_stream_cut_and_wide_caps_equal_jax():
    """cap below the degree (the length stays the degree, as in the JAX
    package) and above it; the last vertex reads SENTINEL past its row."""
    edges, n = EDGES["plc"]
    g, jg = build_csr(edges, n), jbuild_csr(edges, n)
    hub = int(g.degrees.numpy().argmax())
    for v, cap in ((hub, 8), (hub, 512), (n - 1, None), (n - 1, 300), (0, 1)):
        assert_same_stream(neighbors_stream(g, v, cap), jneighbors_stream(jg, v, cap))
    # a cap that cuts rows gives the same nested count as the JAX package
    s = neighbors_stream(g, hub)
    assert int(s_nestinter(g, s, cap=128)) == int(j_nestinter(jg, jneighbors_stream(jg, hub),
                                                              cap=128))


# ---------------------------------------------------------------------------
# the worklist oracle, and the scan compaction held to it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,cap,out_items", [(16, 256, 16 * 256 + 128), (16, 256, 700),
                                             (7, 128, 7 * 128), (33, 384, 64),
                                             (5, 128, 4096)])
def test_batch_compact_items_equals_jax_oracle_and_scan(B, cap, out_items):
    rng = np.random.default_rng(B * cap + out_items)
    rows = np.sort(rng.integers(0, 5000, (B, cap)), axis=1).astype(np.int32)
    counts = rng.integers(0, cap + 1, B).astype(np.int32)
    counts[rng.integers(0, B)] = 0                              # an empty row
    rows[np.arange(cap)[None, :] >= counts[:, None]] = SENTINEL
    got = batch_compact_items(torch.from_numpy(rows), torch.from_numpy(counts), out_items)
    want = jbatch_compact_items(rows, counts, out_items)
    for x, y in zip(got, want):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    keep = torch.from_numpy(np.arange(cap)[None, :] < counts[:, None])
    scan = batch_compact_scan(torch.from_numpy(rows), keep, cap, out_items)
    for x, y in zip(scan[2:], got):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(scan[1].numpy(), counts)
