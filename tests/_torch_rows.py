"""Seeded numpy inputs for the port's intersect tests: sorted SENTINEL-padded
int32 rows with random lengths, empty rows, and bound vectors."""
import numpy as np
import torch

from repro_torch.core.stream import SENTINEL


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
