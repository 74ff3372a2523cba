"""GRAMER-style exhaustive-check baseline (§II-A, [64]).

Enumerates *all* connected subgraphs up to the pattern size (oblivious to
the pattern), then performs the isomorphic check at full size — exactly the
method the paper argues is algorithmically inferior (its Fig. 8 shows
pattern enumeration on an unmodified CPU beating GRAMER). We reproduce that
gap in benchmarks/bench_mining.py.

Connected subgraphs are enumerated once each via the standard ESU-style
rule: extend S only with vertices w > min(S) that neighbor S and are not in
S, tracking the extension frontier to avoid duplicates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph

PATTERN_CHECKS = {
    "triangle": (3, lambda adj, vs: _num_edges(adj, vs) == 3),
    "3-chain": (3, lambda adj, vs: _num_edges(adj, vs) == 2),
    "4-clique": (4, lambda adj, vs: _num_edges(adj, vs) == 6),
    "5-clique": (5, lambda adj, vs: _num_edges(adj, vs) == 10),
    # 4-vertex induced motifs (ESU enumerates connected sets, so 3 edges =>
    # a tree: star iff some vertex touches all others, else path)
    "tailed-triangle": (4, lambda adj, vs: _num_edges(adj, vs) == 4 and _has_triangle(adj, vs)),
    "diamond": (4, lambda adj, vs: _num_edges(adj, vs) == 5),
    "4-cycle": (4, lambda adj, vs: _num_edges(adj, vs) == 4 and not _has_triangle(adj, vs)),
    "4-star": (4, lambda adj, vs: _num_edges(adj, vs) == 3 and _max_deg_in(adj, vs) == 3),
    "4-path": (4, lambda adj, vs: _num_edges(adj, vs) == 3 and _max_deg_in(adj, vs) == 2),
}


def _max_deg_in(adj, vs) -> int:
    return max(sum(1 for v in vs if v != u and v in adj[u]) for u in vs)


def _num_edges(adj, vs) -> int:
    return sum(1 for i, u in enumerate(vs) for v in vs[i + 1:] if v in adj[u])


def _has_triangle(adj, vs) -> bool:
    for i, a in enumerate(vs):
        for j in range(i + 1, len(vs)):
            b = vs[j]
            if b not in adj[a]:
                continue
            for c in vs[j + 1:]:
                if c in adj[a] and c in adj[b]:
                    return True
    return False


def exhaustive_count(g: CSRGraph, pattern: str) -> int:
    """Count embeddings of ``pattern`` by exhaustive subgraph enumeration.

    Counts *connected vertex sets* whose induced subgraph passes the check —
    this matches the vertex-induced semantics GRAMER uses; for cliques and
    (non-induced-agnostic) triangles the result equals pattern enumeration's.
    Exponential: intended for small graphs only (it is the baseline to beat).
    """
    size, check = PATTERN_CHECKS[pattern]
    indptr = np.asarray(g.indptr)
    indices = np.asarray(g.indices)
    adj = [set(indices[indptr[v]: indptr[v + 1]].tolist())
           for v in range(g.num_vertices)]
    count = 0
    for v in range(g.num_vertices):
        ext = [u for u in adj[v] if u > v]
        # ESU (Wernicke): each connected vertex set enumerated exactly once.
        # ``blocked`` = vs ∪ N(vs): new candidates must be *exclusive*
        # neighbors of the newly added vertex.
        stack = [([v], ext, adj[v] | {v})]
        while stack:
            vs, frontier, blocked = stack.pop()
            if len(vs) == size:
                if check(adj, vs):
                    count += 1
                continue
            for i, w in enumerate(frontier):
                new_ext = frontier[i + 1:] + [
                    u for u in adj[w] if u > v and u not in blocked]
                stack.append((vs + [w], new_ext, blocked | adj[w] | {w}))
    return count
