"""Frequent subgraph mining with MNI (minimum-image) support (§VI-B).

Patterns: all connected vertex-labelled patterns with <= 3 edges —
  edge (2 vertices), wedge (path of 3), triangle, 3-star, path of 4.
Matching is *non-induced* subgraph isomorphism (GraMi/Peregrine semantics).

Support:
  MNI(P) = min over pattern vertices u of |{φ(u) : φ an embedding}|  — the
  minimum-image metric [Bringmann & Nijssen], which satisfies the Downward
  Closure Property the paper insists on (§VI-B).
  sFSM uses the *embedding count* instead — GRAMER's incorrect support that
  violates downward closure; implemented for the comparison experiments only.

Downward closure prunes candidates: a k-edge candidate is evaluated only if
all its (k-1)-edge sub-patterns were frequent.

Engineering: domains are boolean masks over V computed vectorised from
neighbor-label count tables; embeddings come from the wavefront engine's
FSM pattern batch (``apps.fsm_pattern_feed``) — the engine-fed plans merged
into one ``PlanForest`` and executed in a single feed pass on a
``mining.session.Miner`` (pass ``miner=`` to reuse a caller-held session;
repeated FSM sweeps over one graph then rebuild nothing). Today the batch
is the compiled triangle *emit* plan, whose worklists are compacted on
device (``ops.xinter_compact_csr``: the expand and items kernels on a
card) so the embedding feed never round-trips through host
``np.nonzero``; further engine-fed patterns join the batch (and share its
canonical prefixes) via ``apps.FSM_FEED_PLANS``. Only path-4 domains use a
per-edge host loop (FSM support calculation is host-dominated — the
paper's own observation for why FSM sees the smallest speedup, Fig. 9).

The counterpart of ``repro.mining.fsm``: the domain code is the JAX
package's, line for line, on numpy arrays read from the graph on the host;
only the triangle feed runs on the session's device (``cuda`` unless
``device="cpu"`` or a ``miner=`` says otherwise).
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.graph.csr import CSRGraph
from .apps import fsm_pattern_feed

# ---------------------------------------------------------------------------
# canonical pattern keys
# ---------------------------------------------------------------------------


def edge_key(la: int, lb: int):
    return ("edge", tuple(sorted((la, lb))))


def wedge_key(la: int, lb: int, lc: int):
    """lb is the center label."""
    lo, hi = sorted((la, lc))
    return ("wedge", (lo, lb, hi))


def triangle_key(la, lb, lc):
    return ("triangle", tuple(sorted((la, lb, lc))))


def star3_key(center, leaves):
    return ("star3", (center, tuple(sorted(leaves))))


def path4_key(la, lb, lc, ld):
    seq = (la, lb, lc, ld)
    return ("path4", min(seq, seq[::-1]))


def random_labels(num_vertices: int, num_labels: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_labels, size=num_vertices, dtype=np.int32)


# ---------------------------------------------------------------------------
# shared precomputation
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self, g: CSRGraph, labels: np.ndarray):
        g = g.to("cpu")     # the domain code reads the CSR on the host
        self.g = g
        self.labels = np.asarray(labels, dtype=np.int32)
        self.num_labels = int(self.labels.max()) + 1 if self.labels.size else 0
        self.indptr = np.asarray(g.indptr)
        self.indices = np.asarray(g.indices)[: g.num_edges]
        self.src = np.repeat(np.arange(g.num_vertices, dtype=np.int32),
                             np.diff(self.indptr).astype(np.int64))
        # nbr_label_count[v, l] = # neighbors of v with label l
        self.nlc = np.zeros((g.num_vertices, self.num_labels), dtype=np.int32)
        np.add.at(self.nlc, (self.src, self.labels[self.indices]), 1)

    def nbrs(self, v) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]


def _support(domains: dict) -> int:
    return min((int(m.sum()) for m in domains.values()), default=0)


# ---------------------------------------------------------------------------
# per-pattern evaluators: return (mni_support, embedding_count)
# ---------------------------------------------------------------------------


def _eval_edge(ctx: _Ctx, la: int, lb: int):
    L = ctx.labels
    src_l, dst_l = L[ctx.src], L[ctx.indices]
    if la == lb:
        dom = np.zeros(ctx.g.num_vertices, bool)
        sel = (src_l == la) & (dst_l == la)
        dom[ctx.src[sel]] = True
        count = int(sel.sum()) // 2
        return _support({("end", la): dom}), count
    dom_a = np.zeros(ctx.g.num_vertices, bool)
    dom_b = np.zeros(ctx.g.num_vertices, bool)
    sel = (src_l == la) & (dst_l == lb)
    dom_a[ctx.src[sel]] = True
    dom_b[ctx.indices[sel]] = True
    return _support({("end", la): dom_a, ("end", lb): dom_b}), int(sel.sum())


def _eval_wedge(ctx: _Ctx, la: int, lb: int, lc: int):
    L, nlc = ctx.labels, ctx.nlc
    if la == lc:
        center = (L == lb) & (nlc[:, la] >= 2)
        cnt = nlc[center][:, la].astype(np.int64)
        count = int((cnt * (cnt - 1) // 2).sum())
        leaf = np.zeros(ctx.g.num_vertices, bool)
        sel = (L[ctx.indices] == la) & center[ctx.src]
        leaf[ctx.indices[sel]] = True
        return _support({("center",): center, ("leaf", la): leaf}), count
    center = (L == lb) & (nlc[:, la] >= 1) & (nlc[:, lc] >= 1)
    count = int((nlc[center][:, la].astype(np.int64)
                 * nlc[center][:, lc].astype(np.int64)).sum())
    doms = {("center",): center}
    for ll in (la, lc):
        leaf = np.zeros(ctx.g.num_vertices, bool)
        sel = (L[ctx.indices] == ll) & center[ctx.src]
        leaf[ctx.indices[sel]] = True
        doms[("leaf", ll)] = leaf
    return _support(doms), count


def _eval_triangle(ctx: _Ctx, tris: np.ndarray, la, lb, lc):
    want = tuple(sorted((la, lb, lc)))
    L = ctx.labels
    tl = np.sort(L[tris], axis=1)
    sel = np.all(tl == np.asarray(want, dtype=L.dtype)[None, :], axis=1)
    matched = tris[sel]
    doms = {}
    for ll in set(want):
        dom = np.zeros(ctx.g.num_vertices, bool)
        vs = matched[L[matched] == ll]
        dom[vs] = True
        doms[("v", ll)] = dom
    return _support(doms), int(matched.shape[0])


def _eval_star3(ctx: _Ctx, center_l: int, leaves: tuple[int, int, int]):
    import math
    L, nlc = ctx.labels, ctx.nlc
    mult = {lab: leaves.count(lab) for lab in set(leaves)}
    ok = L == center_l
    for lab, m in mult.items():
        ok &= nlc[:, lab] >= m
    count = 0
    if ok.any():
        per = np.ones(int(ok.sum()), dtype=np.int64)
        for lab, m in mult.items():
            c = nlc[ok][:, lab].astype(np.int64)
            num = np.ones_like(c)          # C(c, m), vectorised
            for i in range(m):
                num = num * (c - i)
            per *= num // math.factorial(m)
        count = int(per.sum())
    doms = {("center",): ok}
    for lab in set(leaves):
        leaf = np.zeros(ctx.g.num_vertices, bool)
        sel = (L[ctx.indices] == lab) & ok[ctx.src]
        leaf[ctx.indices[sel]] = True
        doms[("leaf", lab)] = leaf
    return _support(doms), count


def _eval_path4(ctx: _Ctx, canon: tuple[int, int, int, int]):
    la, lb, lc, ld = canon
    palindrome = canon == canon[::-1]
    L = ctx.labels
    dom = [np.zeros(ctx.g.num_vertices, bool) for _ in range(4)]
    count = 0
    sel = np.nonzero((L[ctx.src] == lb) & (L[ctx.indices] == lc))[0]
    for e in sel:
        b, c = int(ctx.src[e]), int(ctx.indices[e])
        nb, nc = ctx.nbrs(b), ctx.nbrs(c)
        a_cand = nb[(L[nb] == la) & (nb != c)]
        d_cand = nc[(L[nc] == ld) & (nc != b)]
        if a_cand.size == 0 or d_cand.size == 0:
            continue
        if la == ld:
            common = np.intersect1d(a_cand, d_cand, assume_unique=True)
            pairs = a_cand.size * d_cand.size - common.size
        else:
            common = np.empty(0, dtype=a_cand.dtype)
            pairs = a_cand.size * d_cand.size
        if pairs <= 0:
            continue
        count += pairs
        dom[1][b] = True
        dom[2][c] = True
        # a qualifies unless its only partner choice is itself
        if la == ld:
            ok_a = np.ones(a_cand.size, bool)
            if d_cand.size == 1:
                ok_a &= a_cand != d_cand[0]
            dom[0][a_cand[ok_a]] = True
            ok_d = np.ones(d_cand.size, bool)
            if a_cand.size == 1:
                ok_d &= d_cand != a_cand[0]
            dom[3][d_cand[ok_d]] = True
        else:
            dom[0][a_cand] = True
            dom[3][d_cand] = True
    if palindrome:
        assert count % 2 == 0
        count //= 2
    doms = {(i,): dom[i] for i in range(4)}
    return _support(doms), count


# ---------------------------------------------------------------------------
# the miner
# ---------------------------------------------------------------------------


def _mine(g: CSRGraph, labels: np.ndarray, min_support: int, max_edges: int,
          metric: str, miner=None, device: str = "cuda"):
    """metric='mni' (fsm) or 'count' (sfsm); ``miner`` is an optional
    ``mining.session.Miner`` the engine feed runs on (else the shared
    session on ``device``)."""
    ctx = _Ctx(g, labels)
    ls = sorted(set(ctx.labels.tolist()))
    results: dict = {}
    measure = {}

    def value(sup, cnt):
        return sup if metric == "mni" else cnt

    # --- level 1: edges ---
    freq_edges = set()
    for la, lb in itertools.combinations_with_replacement(ls, 2):
        sup, cnt = _eval_edge(ctx, la, lb)
        v = value(sup, cnt)
        measure[edge_key(la, lb)] = v
        if v >= min_support:
            freq_edges.add(edge_key(la, lb))
            results[edge_key(la, lb)] = v
    if max_edges == 1 or not freq_edges:
        return results

    # --- level 2: wedges (downward closure on both edges) ---
    freq_wedges = set()
    for lb in ls:                      # center
        for la, lc in itertools.combinations_with_replacement(ls, 2):
            if edge_key(la, lb) not in freq_edges or \
               edge_key(lb, lc) not in freq_edges:
                continue
            sup, cnt = _eval_wedge(ctx, la, lb, lc)
            v = value(sup, cnt)
            k = wedge_key(la, lb, lc)
            measure[k] = v
            if v >= min_support:
                freq_wedges.add(k)
                results[k] = v
    if max_edges == 2 or not freq_wedges:
        return results

    # --- level 3 ---
    tris = fsm_pattern_feed(g, miner=miner, device=device)[0]   # session triangle emit
    # triangles: all 3 edges + all 3 wedges frequent
    for la, lb, lc in itertools.combinations_with_replacement(ls, 3):
        edges_ok = all(edge_key(x, y) in freq_edges
                       for x, y in [(la, lb), (lb, lc), (la, lc)])
        wedges_ok = all(wedge_key(x, m, y) in freq_wedges
                        for x, m, y in [(lb, la, lc), (la, lb, lc), (la, lc, lb)])
        if not (edges_ok and wedges_ok):
            continue
        sup, cnt = _eval_triangle(ctx, tris, la, lb, lc)
        v = value(sup, cnt)
        k = triangle_key(la, lb, lc)
        if v >= min_support:
            results[k] = v
    # 3-stars
    for center in ls:
        for leaves in itertools.combinations_with_replacement(ls, 3):
            if not all(edge_key(center, lf) in freq_edges for lf in leaves):
                continue
            if not all(wedge_key(x, center, y) in freq_wedges
                       for x, y in itertools.combinations(leaves, 2)):
                continue
            sup, cnt = _eval_star3(ctx, center, leaves)
            v = value(sup, cnt)
            if v >= min_support:
                results[star3_key(center, leaves)] = v
    # 4-paths
    seen = set()
    for la in ls:
        for lb in ls:
            for lc in ls:
                for ld in ls:
                    k = path4_key(la, lb, lc, ld)
                    if k in seen:
                        continue
                    seen.add(k)
                    canon = k[1]
                    a, b, c, d = canon
                    if edge_key(a, b) not in freq_edges or \
                       edge_key(b, c) not in freq_edges or \
                       edge_key(c, d) not in freq_edges:
                        continue
                    if wedge_key(a, b, c) not in freq_wedges or \
                       wedge_key(b, c, d) not in freq_wedges:
                        continue
                    sup, cnt = _eval_path4(ctx, canon)
                    v = value(sup, cnt)
                    if v >= min_support:
                        results[k] = v
    return results


def fsm(g: CSRGraph, labels: np.ndarray, min_support: int,
        max_edges: int = 3, miner=None, device: str = "cuda") -> dict:
    """FSM with MNI support (downward-closure sound)."""
    return _mine(g, labels, min_support, max_edges, "mni", miner=miner, device=device)


def sfsm(g: CSRGraph, labels: np.ndarray, min_support: int,
         max_edges: int = 3, miner=None, device: str = "cuda") -> dict:
    """simple-FSM: GRAMER's embedding-count support (comparison only)."""
    return _mine(g, labels, min_support, max_edges, "count", miner=miner, device=device)
