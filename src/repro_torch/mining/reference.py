"""Brute-force oracles for the mining applications (plain Python sets,
numpy, and one torch census).

The counterpart of ``repro.mining.reference``, without networkx: the
triangle and clique oracles enumerate increasing vertex sequences over the
adjacency rows as Python sets (what ``nx.triangles`` and
``nx.enumerate_all_cliques`` count), and ``four_motif_counts`` classifies
every vertex quadruple on the session's device (``cuda`` unless
``device="cpu"``), a chunk of quadruples at a time. ``to_networkx`` has no
counterpart: it returns a networkx type.

Nothing here calls the engine (``mining.engine``, ``core.batch``,
``kernels``, a ``Miner``): the oracles are definitions the engine, the
InHouseAutoMine baseline and the exhaustive-check baseline are held to.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, edge_list


def _rows(g: CSRGraph) -> list[np.ndarray]:
    """Each vertex's sorted neighbour row, on the host."""
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()[: g.num_edges]
    return [indices[indptr[v]: indptr[v + 1]] for v in range(g.num_vertices)]


def _up_sets(g: CSRGraph) -> list[set]:
    """N+(v): the neighbours of v above v, as sets."""
    return [set(int(w) for w in row[row > v]) for v, row in enumerate(_rows(g))]


def _cliques(g: CSRGraph, k: int):
    """Every increasing sequence v_1 < ... < v_k whose pairs are all edges."""
    up = _up_sets(g)

    def grow(prefix, cand):
        if len(prefix) == k:
            yield prefix
            return
        for w in sorted(cand):
            yield from grow(prefix + (w,), cand & up[w])

    for v in range(g.num_vertices):
        yield from grow((v,), up[v])


def triangle_count(g: CSRGraph) -> int:
    """Triangles, each u < v < w once."""
    up = _up_sets(g)
    return sum(len(up[u] & up[v]) for u in range(g.num_vertices) for v in up[u])


def clique_count(g: CSRGraph, k: int) -> int:
    return sum(1 for _ in _cliques(g, k))


def three_chain_count(g: CSRGraph, induced: bool = False) -> int:
    deg = g.degrees.cpu().numpy().astype(np.int64)
    non_induced = int((deg * (deg - 1) // 2).sum())
    if not induced:
        return non_induced
    return non_induced - 3 * triangle_count(g)


def tailed_triangle_count(g: CSRGraph) -> int:
    """Σ over triangles of (deg(a)+deg(b)+deg(c) - 6)."""
    deg = g.degrees.cpu().numpy().astype(np.int64)
    return sum(int(deg[list(c)].sum() - 6) for c in _cliques(g, 3))


def motif3(g: CSRGraph) -> dict[str, int]:
    return {"triangle": triangle_count(g),
            "chain": three_chain_count(g, induced=True)}


# degree-multiset signature of each connected 4-vertex induced subgraph
_MOTIF4_SIG = {
    (1, 1, 2, 2): "4-path", (1, 1, 1, 3): "4-star", (2, 2, 2, 2): "4-cycle",
    (1, 2, 2, 3): "paw", (2, 2, 3, 3): "diamond", (3, 3, 3, 3): "4-clique",
}


def _adjacency(g: CSRGraph, device) -> torch.Tensor:
    """The dense (n, n) bool adjacency matrix on ``device``."""
    n = g.num_vertices
    e = torch.from_numpy(edge_list(g).astype(np.int64)).to(device)
    A = torch.zeros((n, n), dtype=torch.bool, device=device)
    A[e[:, 0], e[:, 1]] = True
    return A


def _triples(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(j, k, l) of every triple j < k < l < n, ordered by l: the triples
    below a vertex i are the first C(i, 3)."""
    j_of, k_of = torch.tril_indices(n, n, -1, device=device).flip(0)   # pairs by k, then j
    lv = torch.arange(n, device=device)
    per_l = lv * (lv - 1) // 2                                         # pairs below l
    L = torch.repeat_interleave(lv, per_l)
    pos = torch.arange(L.numel(), device=device) \
        - torch.repeat_interleave(torch.cumsum(per_l, 0) - per_l, per_l)
    return j_of[pos], k_of[pos], L


def four_motif_counts(g: CSRGraph, device=None) -> dict[str, int]:
    """Brute-force induced 4-motif census: classify every vertex quadruple
    by the degree multiset of its induced subgraph (unique per motif; the
    disconnected shapes — incl. triangle+isolated (0,2,2,2) — drop out).

    Runs on ``device`` (default ``cuda``; ``"cpu"`` for the CPU): the dense
    adjacency as a bool tensor, then one chunk of quadruples per largest
    vertex i, each (j < k < l < i) from a table of triples ordered by l, so
    peak memory stays near C(n, 3) int64 slots (about 0.2 GB at n = 256)
    rather than C(n, 4). Each chunk adds the six pair hits per slot, sorts
    the four degrees and tallies the base-4 codes with ``torch.bincount``."""
    device = torch.device("cuda" if device is None else device)
    out = {m: 0 for m in _MOTIF4_SIG.values()}
    n = g.num_vertices
    if n < 4:
        return out
    A = _adjacency(g, device)
    J, K, L = _triples(n, device)
    jk, jl, kl = A[J, K].to(torch.int8), A[J, L].to(torch.int8), A[K, L].to(torch.int8)
    inner = (jk + jl, jk + kl, jl + kl)            # each triple slot's hits inside it
    place = torch.tensor([64, 16, 4, 1], device=device)
    tally = torch.zeros(256, dtype=torch.int64, device=device)
    for i in range(3, n):
        m = (i - 2) * (i - 1) * i // 6            # C(i, 3): the triples below i
        row = A[i]
        hits = [row[t[:m]].to(torch.int8) for t in (J, K, L)]
        deg = torch.stack([hits[0] + hits[1] + hits[2]]
                          + [h + s[:m] for h, s in zip(hits, inner)], dim=1)
        code = (deg.sort(dim=1).values.long() * place).sum(dim=1)
        tally += torch.bincount(code, minlength=256)
    counts = tally.cpu().tolist()
    for sig, m in _MOTIF4_SIG.items():
        out[m] = int(counts[sum(d * p for d, p in zip(sig, (64, 16, 4, 1)))])
    return out


def pattern_count_oracle(g: CSRGraph, pat) -> int:
    """Count embeddings of a ``mining.plan.Pattern`` by brute force.

    Enumerates every injective vertex mapping (itertools.permutations),
    checks pattern edges (plus non-edges when ``pat.induced``) and the
    declared symmetry-breaking restrictions, then divides by ``pat.div`` —
    the semantic definition every compiled ``WavePlan`` must reproduce.
    Exponential: tiny graphs only.
    """
    n = g.num_vertices
    A = _adjacency(g, "cpu").numpy()
    k = pat.k
    pairs = [(i, j, pat.adj[i][j]) for i in range(k) for j in range(i + 1, k)]
    total = 0
    for vs in itertools.permutations(range(n), k):
        ok = all(A[vs[i], vs[j]] == want if pat.induced
                 else (not want or A[vs[i], vs[j]])
                 for i, j, want in pairs)
        if ok and all(vs[i] < vs[j] for i, j in pat.restrictions):
            total += 1
    assert total % pat.div == 0
    return total // pat.div


def weighted_pattern_oracle(g: CSRGraph, pat, op: str = "sum") -> float:
    """SVPU value-plane oracle: aggregate embedding weights by brute force.

    An embedding's value is the product over ALL pattern edges of the
    matched graph edge's weight (``g.edge_values``); the query result is
    the ``op`` ('sum' | 'max' | 'min') reduction over every embedding
    ``pattern_count_oracle`` would count. Mirrors ``Miner.aggregate``:
    requires a fully symmetry-broken schedule (``pat.div == 1``) and
    returns 0.0 when no embedding exists. Host float64 enumeration, the
    products and the sum in enumeration order (Python's ``sum``) —
    exponential, tiny graphs only.
    """
    if g.edge_values is None:
        raise ValueError("graph has no edge_values (see with_edge_values)")
    if pat.div != 1:
        raise ValueError("weighted oracle needs div == 1 schedules")
    n = g.num_vertices
    e = edge_list(g)
    vals = g.edge_values.cpu().numpy().astype(np.float64)[: g.num_edges]
    A = _adjacency(g, "cpu").numpy()
    W = np.zeros((n, n), dtype=np.float64)
    W[e[:, 0], e[:, 1]] = vals
    k = pat.k
    pairs = [(i, j, pat.adj[i][j]) for i in range(k) for j in range(i + 1, k)]
    acc: list[float] = []
    for vs in itertools.permutations(range(n), k):
        ok = all(A[vs[i], vs[j]] == want if pat.induced
                 else (not want or A[vs[i], vs[j]])
                 for i, j, want in pairs)
        if ok and all(vs[i] < vs[j] for i, j in pat.restrictions):
            value = 1.0
            for i, j, want in pairs:
                if want:
                    value *= W[vs[i], vs[j]]
            acc.append(value)
    if not acc:
        return 0.0
    if op == "sum":
        return float(sum(acc))
    if op == "max":
        return float(max(acc))
    if op == "min":
        return float(min(acc))
    raise ValueError(f"op must be 'sum' | 'max' | 'min', got {op!r}")


def fsm_oracle(g: CSRGraph, labels: np.ndarray, min_support: int,
               metric: str = "mni") -> dict:
    """Brute-force FSM oracle (tiny labelled graphs only).

    Enumerates every non-induced embedding of each <=3-edge pattern shape
    explicitly, fills MNI domains per pattern-vertex orbit, and returns
    {canonical pattern: support} for the frequent ones. ``metric`` = 'mni'
    or 'count' (the sFSM/GRAMER metric). Shares canonical keys with
    ``repro_torch.mining.fsm`` so results are directly comparable.
    """
    from .fsm import edge_key, star3_key, triangle_key, wedge_key

    L = np.asarray(labels)
    adj = _rows(g)
    domains: dict[tuple, dict[tuple, set]] = {}
    counts: dict[tuple, int] = {}

    def add(key, orbit_assignments):
        dom = domains.setdefault(key, {})
        for orbit, v in orbit_assignments:
            dom.setdefault(orbit, set()).add(int(v))
        counts[key] = counts.get(key, 0) + 1

    # edges (unordered)
    for u in range(g.num_vertices):
        for v in adj[u]:
            if v <= u:
                continue
            k = edge_key(L[u], L[v])
            add(k, [(("end", int(L[u])), u), (("end", int(L[v])), v)])
    # wedges: center m, unordered leaf pairs
    for m in range(g.num_vertices):
        for a, b in itertools.combinations(adj[m].tolist(), 2):
            k = wedge_key(L[a], L[m], L[b])
            add(k, [(("center",), m), (("leaf", int(L[a])), a),
                    (("leaf", int(L[b])), b)])
    # triangles
    for u in range(g.num_vertices):
        for v in adj[u]:
            if v <= u:
                continue
            common = np.intersect1d(adj[u], adj[v], assume_unique=True)
            for w in common[common > v]:
                k = triangle_key(L[u], L[v], L[w])
                add(k, [(("v", int(L[x])), x) for x in (u, v, int(w))])
    # 3-stars: center + unordered leaf triples
    for m in range(g.num_vertices):
        for tri in itertools.combinations(adj[m].tolist(), 3):
            k = star3_key(int(L[m]), tuple(int(L[x]) for x in tri))
            add(k, [(("center",), m)] + [(("leaf", int(L[x])), x) for x in tri])
    # 4-paths: ordered tuples, registered in canonical orientation(s)
    for b in range(g.num_vertices):
        for c in adj[b]:
            for a in adj[b]:
                if a == c:
                    continue
                for d in adj[int(c)]:
                    if d == b or d == a:
                        continue
                    seq = (int(L[a]), int(L[b]), int(L[c]), int(L[d]))
                    canon = min(seq, seq[::-1])
                    k = ("path4", canon)
                    tup = (a, b, int(c), int(d))
                    if seq == canon:
                        add(k, [((i,), tup[i]) for i in range(4)])
                    if seq[::-1] == canon and seq != canon:
                        add(k, [((i,), tup[3 - i]) for i in range(4)])
    # Each path-4 subgraph has exactly two ordered tuples (forward/backward)
    # and exactly one of the two registration branches fires per tuple, so
    # every subgraph registers twice regardless of palindromy => halve.
    out = {}
    for key, dom in domains.items():
        if key[0] == "path4":
            assert counts[key] % 2 == 0
            counts[key] //= 2
        support = min(len(s) for s in dom.values())
        value = support if metric == "mni" else counts[key]
        if value >= min_support:
            out[key] = value
    return out
