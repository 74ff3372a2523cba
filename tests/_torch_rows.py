"""Seeded numpy inputs for the port's intersect tests: sorted SENTINEL-padded
int32 rows with random lengths, empty rows, and bound vectors."""
import numpy as np
import torch

from repro_torch.core.stream import SENTINEL


def T(x):
    """numpy array (or None) -> CPU tensor."""
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


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
