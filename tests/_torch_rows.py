"""Seeded numpy inputs for the port's intersect tests: sorted SENTINEL-padded
int32 rows with random lengths, empty rows, and bound vectors; and the
``one_torch_thread`` fixture the port's heavier test modules import."""
import numpy as np
import pytest
import torch

from repro_torch.core.stream import SENTINEL


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing module on one torch thread, restored after it. The
    tier-1 command runs six test processes side by side; a module of
    chunk-wide torch ops on default threads then spends most of each op with
    its intra-op threads waiting on one another, several times slower than
    alone on one thread. A module imports it as
    ``from _torch_rows import one_torch_thread``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(x):
    """numpy array (or None) -> CPU tensor."""
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def offset_view(x, offset):
    """x's values as a contiguous view ``offset`` elements into a flat buffer
    on x's device (a storage offset: on the card, a row start off a 16-byte
    boundary)."""
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.reshape(-1)
    return flat[offset:].view(x.shape)


def make_rows(rng, batch, cap, hi=4000, empty_prob=0.15):
    """Sorted SENTINEL-padded int32 sets, some rows empty."""
    out = np.full((batch, cap), SENTINEL, np.int32)
    for i in range(batch):
        if rng.random() < empty_prob:
            continue
        n = int(rng.integers(1, cap + 1))
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


def make_bounds(rng, batch, hi=4000):
    """bounds from {SENTINEL, random, 0}; lbounds -1 or random below."""
    bounds = rng.choice([SENTINEL, 0, -1], size=batch).astype(np.int64)
    rnd = rng.integers(0, hi, size=batch)
    bounds = np.where(bounds == -1, rnd, bounds).astype(np.int32)
    lbounds = np.where(rng.random(batch) < 0.5, -1, rnd // 3).astype(np.int32)
    return bounds, lbounds


def make_case(seed, batch, cap_a, cap_b):
    rng = np.random.default_rng(seed)
    hi = 2 * max(cap_a, cap_b)
    a, b = make_rows(rng, batch, cap_a, hi), make_rows(rng, batch, cap_b, hi)
    b[0] = a[0, :cap_b] if cap_a >= cap_b else b[0]     # a row of full overlap
    bounds, lbounds = make_bounds(rng, batch, hi)
    bounds[1] = 0                                        # a dead row
    return a, b, bounds, lbounds


def make_level_case(seed, batch, cap_a, k, cap_b):
    """A k-reference level's inputs: a (B, cap_a), the (k, B, cap_b) stack
    bs, bounds/lbounds with a dead row 1, and (B, 2) excludes holding keys
    of A (and -1, the no-op). Ref 0 of row 0 is A's own row, so an INTER
    first ref keeps something; keys are drawn from a narrow range so that
    rows overlap."""
    rng = np.random.default_rng(seed)
    hi = cap_a + cap_b
    a = make_rows(rng, batch, cap_a, hi, empty_prob=0.1)
    bs = np.stack([make_rows(rng, batch, cap_b, hi, empty_prob=0.1) for _ in range(k)])
    bs[0, 0] = a[0, :cap_b] if cap_a >= cap_b else bs[0, 0]
    bounds, lbounds = make_bounds(rng, batch, hi)
    bounds[0], lbounds[0] = SENTINEL, -1
    bounds[1] = 0
    excl = np.full((batch, 2), -1, np.int32)
    for i in range(batch):
        live = a[i][a[i] != SENTINEL]
        if live.size:
            excl[i, 0] = rng.choice(live)
            if rng.random() < 0.5:
                excl[i, 1] = rng.choice(live)
    return a, bs, bounds, lbounds, excl


def make_values(rng, shape, dyadic=True):
    """f32 values beside keys: dyadic ({1/4, 1/2, 3/4, 1}, so products and
    small sums are exact in f32 in any order), else non-dyadic in [0.5, 2)
    (positive, so a sum has no cancellation and a relative tolerance holds)."""
    if dyadic:
        return (rng.integers(1, 5, size=shape) * 0.25).astype(np.float32)
    return rng.uniform(0.5, 2.0, size=shape).astype(np.float32)


def make_agg_case(seed, batch, cap_a, k, cap_b, dyadic=True):
    """``make_level_case`` plus the value lane's a_vals (B, cap_a), b_vals
    (k, B, cap_b) and scale (B,), values 0.0 on SENTINEL keys."""
    a, bs, bounds, lbounds, excl = make_level_case(seed, batch, cap_a, k, cap_b)
    rng = np.random.default_rng(seed + 1)
    a_vals = np.where(a != SENTINEL, make_values(rng, a.shape, dyadic), 0).astype(np.float32)
    b_vals = np.where(bs != SENTINEL, make_values(rng, bs.shape, dyadic), 0).astype(np.float32)
    scale = make_values(rng, (batch,), dyadic)
    return a, bs, bounds, lbounds, excl, a_vals, b_vals, scale


def make_vinter_case(seed, batch, cap_a, cap_b, dyadic=True):
    """S_VINTER inputs: key rows drawn from a range where they overlap, and
    values beside them (0.0 on SENTINEL keys)."""
    rng = np.random.default_rng(seed)
    hi = cap_a + cap_b
    a = make_rows(rng, batch, cap_a, hi, empty_prob=0.1)
    b = make_rows(rng, batch, cap_b, hi, empty_prob=0.1)
    b[0] = a[0, :cap_b] if cap_a >= cap_b else b[0]
    va = np.where(a != SENTINEL, make_values(rng, a.shape, dyadic), 0).astype(np.float32)
    vb = np.where(b != SENTINEL, make_values(rng, b.shape, dyadic), 0).astype(np.float32)
    return a, va, b, vb


# the weighted queries of the port, each with its number of pattern edges:
# an embedding's value is a product of that many weights in {1/4, .., 1}
AGG_QUERIES = {"triangle": 3, "4-clique": 6, "5-clique": 10, "three-chain-induced": 2,
               "diamond": 5, "paw": 4, "4-cycle": 4, "tailed-triangle": 4, "4-path": 3}
AGG_OPS = ("sum", "max", "min")


def sum_is_exact(total: float, n_edges: int) -> bool:
    """Whether every summation order gives ``total`` exactly: values are
    positive multiples of 4^-n_edges, so every partial is at most the total
    and f32 holds each exactly while the total is below 2^24 units."""
    return abs(total) < 2.0 ** (24 - 2 * n_edges)


def make_csr(stacks, value_stacks=()):
    """One CSR whose vertices hold the live keys of the given (B, cap) row
    matrices in turn (vertex j * B + i is row i of stack j), with a value
    plane per list of value matrices in ``value_stacks``: rows start on any
    4-byte boundary, empty rows are degree-0 vertices, and the last stack's
    last row is the last vertex. -> (indptr, indices, [values], [ids])."""
    live = [x != SENTINEL for x in stacks]
    lens = np.concatenate([m.sum(axis=1) for m in live])
    indptr = np.zeros(lens.size + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate([x[m] for x, m in zip(stacks, live)]
                             + [np.full(128, SENTINEL, np.int32)]).astype(np.int32)
    values = [np.concatenate([v[m] for v, m in zip(vs, live)]
                             + [np.zeros(128, np.float32)]).astype(np.float32)
              for vs in value_stacks]
    B = stacks[0].shape[0]
    ids = [np.arange(j * B, (j + 1) * B, dtype=np.int32) for j in range(len(stacks))]
    return indptr, indices, values, ids


def make_worklist(seed, parents, out_cap, cap_b, total, items):
    """A count leaf's operands as its parent expand leaves them: a CSR over
    ``nv`` vertices (some rows longer than ``cap_b``, so cut, some empty),
    ``rows2`` (parents, out_cap) of sorted keys over the vertices, SENTINEL
    after each row's survivors, the worklist ``src`` / ``verts2`` of
    ``items`` entries, the first ``total`` live (src sorted; every seventh
    vertex 0, whose bound 0 kills its row), the rest (0, 0) as
    ``expand_items`` leaves them, and ``cols`` (3, parents): the three
    columns the parent forwards, vertex ids (one in nine 0), so that
    ``verts2`` is column 3. -> dict of numpy arrays and ``total``."""
    rng = np.random.default_rng(seed)
    nv = 2 * max(out_cap, cap_b)
    degs = rng.integers(0, cap_b + cap_b // 2 + 1, nv)
    degs[rng.random(nv) < 0.1] = 0
    indptr = np.zeros(nv + 1, np.int32)
    np.cumsum(degs, out=indptr[1:])
    indices = np.concatenate([np.sort(rng.choice(nv, d, replace=False)) for d in degs]
                             + [np.full(128, SENTINEL)]).astype(np.int32)
    src = np.zeros(items, np.int32)
    verts2 = np.zeros(items, np.int32)
    src[:total] = np.sort(rng.integers(0, parents, total))
    verts2[:total] = rng.integers(1, nv, total)
    verts2[:total:7] = 0
    rows2 = make_rows(rng, parents, out_cap, nv)
    cols = rng.integers(1, nv, (3, parents)).astype(np.int32)
    cols[rng.random((3, parents)) < 1 / 9] = 0
    return dict(indptr=indptr, indices=indices, rows2=rows2, src=src, verts2=verts2,
                cols=cols, total=total)


# general leaves over make_worklist's columns (0, 1, 2 forwarded, 3 the new
# vertex): (base column or None for the carried rows2, refs, pol, ub, lb,
# exclude); paw's leaf is the second
GENERAL_LEAVES = {
    "k1-new-vertex-base": (3, (0,), (1,), (1,), (), ()),
    "k2-sub-excludes": (3, (0, 1), (0, 0), (), (), (0, 1)),
    "k2-forwarded-base-lb": (1, (3, 0), (1, 0), (3,), (2,), ()),
    "k3-carried": (None, (3, 0, 2), (1, 1, 0), (3,), (1,), (2,)),
    "k3-forwarded-base": (2, (0, 1, 3), (1, 0, 0), (0, 1), (), (3,)),
}


def leaf_caps(leaf, cap_a, cap_b):
    """(cap of the base, caps of the references) of a GENERAL_LEAVES leaf:
    references alternate cap_b and cap_a."""
    return cap_a, tuple(cap_b if r % 2 == 0 else cap_a for r in range(len(leaf[1])))


def worklist_count(w, lo, m, cap_a, cap_b, sub=False, leaf=None) -> int:
    """The count of the chunk [lo, lo + m) of ``make_worklist``'s ``w`` by
    Python sets. With no ``leaf``, the carried leaf: per item, the base
    row's keys below the item's vertex, cut at cap_a, that are in
    (``sub``: not in) the vertex's CSR row cut at cap_b. With a
    GENERAL_LEAVES ``leaf``: per item, its base's keys (the carried row cut
    at cap_a, or its base column's CSR row cut at cap_a) inside the bounds
    of its ub and lb columns' vertices, none of its exclude columns'
    vertices, in each INTER and in no SUB reference's CSR row cut at its
    cap (``leaf_caps``)."""
    indptr, indices = w["indptr"], w["indices"]

    def nbrs(v, cap):
        return [int(k) for k in indices[indptr[v]: indptr[v] + min(indptr[v + 1] - indptr[v],
                                                                    cap)]]
    if leaf is None:
        leaf = (None, (3,), (0,) if sub else (1,), (3,), (), ())
        caps_b = (cap_b,)
    else:
        caps_b = leaf_caps(leaf, cap_a, cap_b)[1]
    base, refs, pol, ub, lb, exclude = leaf
    total = 0
    for i in range(lo, lo + m):
        ids = [int(c[w["src"][i]]) for c in w["cols"]] + [int(w["verts2"][i])]
        keys = [int(k) for k in w["rows2"][w["src"][i], :cap_a] if k != SENTINEL] \
            if base is None else nbrs(ids[base], cap_a)
        hi = min([ids[c] for c in ub], default=SENTINEL)
        lo_ = max([ids[c] for c in lb], default=-1)
        out = {ids[c] for c in exclude}
        rows = [(set(nbrs(ids[r], cap)), p) for r, cap, p in zip(refs, caps_b, pol)]
        total += sum(lo_ < k < hi and k not in out and all((k in s) == bool(p) for s, p in rows)
                     for k in keys)
    return total
