"""Plain reference counts of the benchmark's queries, in torch ops.

It reads the edge list the harness generated and nothing of the program:
it builds its own adjacency, orients every edge from the endpoint of lower
(degree, id) to the higher, and lists the triangles, 4-cliques and
5-cliques of that acyclic orientation, each once, by growing a clique
through the out-neighbours of its last vertex and testing the other edges
against the sorted edge keys; the 5-cliques are counted, not listed. The
induced and the tailed patterns follow from those in closed form:

    three-chain(-induced) = sum_v C(d_v, 2) - 3 T
    tailed-triangle       = sum_v t_v (d_v - 2)          (not induced)
    diamond (induced)     = sum_e C(t_e, 2) - 6 K4
    paw (induced)         = tailed-triangle - 4 diamond - 12 K4

with d_v the degree, t_v the triangles at v and t_e the triangles on edge
e. Every count is an int64 sum. The functions run on whichever device the
edges are put on (the harness: the card, once the measured window is over).
"""
from __future__ import annotations

import numpy as np
import torch

# candidates a clique-growing step holds at once (bounds the memory)
BLOCK = 1 << 24

QUERIES = ("triangle", "4-clique", "5-clique", "three-chain", "three-chain-induced",
           "tailed-triangle", "diamond", "paw")

# edges of each query's pattern (the control's sampling scales by p^-edges)
PATTERN_EDGES = {"triangle": 3, "4-clique": 6, "5-clique": 10, "three-chain": 2,
                 "three-chain-induced": 2, "tailed-triangle": 4, "diamond": 5,
                 "paw": 4}


class Adjacency:
    """A simple undirected graph from an (M, 2) edge list: self-loops and
    repeats dropped, both directions held as sorted keys ``src * V + dst``,
    and the acyclic orientation's out-neighbour lists in CSR form."""

    def __init__(self, edges, num_vertices: int, device="cpu"):
        v = int(num_vertices)
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device).reshape(-1, 2)
        e = e[e[:, 0] != e[:, 1]]
        both = torch.cat([e, e.flip(1)])
        self.v = v
        self.keys = torch.unique(both[:, 0] * v + both[:, 1])      # sorted
        src, dst = self.keys // v, self.keys % v
        self.degree = torch.bincount(src, minlength=v)
        # rank: position in (degree, id) order; an edge points up the ranks
        order = torch.argsort(self.degree * v + torch.arange(v, device=device))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(v, device=device)
        up = rank[src] < rank[dst]
        self.out_src, self.out_dst = src[up], dst[up]              # sorted by src
        self.out_degree = torch.bincount(self.out_src, minlength=v)
        self.out_ptr = torch.zeros(v + 1, dtype=torch.int64, device=device)
        self.out_ptr[1:] = torch.cumsum(self.out_degree, 0)
        self.out_keys = self.out_src * v + self.out_dst             # sorted

    def has_edge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Whether each (a, b) is an edge."""
        k = a * self.v + b
        i = torch.searchsorted(self.keys, k).clamp_max(self.keys.numel() - 1)
        return self.keys[i] == k

    def grow(self, cliques: torch.Tensor, count: bool = False):
        """(N, k) cliques in rank order -> the (N', k + 1) cliques that extend
        them by an out-neighbour of their last vertex adjacent to all, or
        with ``count`` their number N' alone."""
        k = cliques.shape[1]
        out, total = [cliques.new_empty((0, k + 1))], 0
        fan = self.out_degree[cliques[:, -1]]
        ends = torch.cumsum(fan, 0)
        lo = 0
        while lo < cliques.shape[0]:
            base = int(ends[lo - 1]) if lo else 0
            hi = int(torch.searchsorted(ends, base + BLOCK, right=True))
            hi = max(hi, lo + 1)
            rows, f = cliques[lo:hi], fan[lo:hi]
            rep = torch.repeat_interleave(torch.arange(rows.shape[0], device=rows.device), f)
            first = torch.cumsum(f, 0) - f
            slot = torch.arange(rep.numel(), device=rows.device) - first[rep]
            cand = self.out_dst[self.out_ptr[rows[rep, -1]] + slot]
            keep = torch.ones_like(cand, dtype=torch.bool)
            for j in range(k - 1):
                keep &= self.has_edge(rows[rep, j], cand)
            if count:
                total += int(keep.sum())
            else:
                out.append(torch.cat([rows[rep[keep]], cand[keep, None]], 1))
            lo = hi
        return total if count else torch.cat(out)


def counts(edges, num_vertices: int, device="cpu") -> dict[str, int]:
    """Every query of ``QUERIES`` on the graph, as Python ints."""
    g = Adjacency(edges, num_vertices, device)
    tri = g.grow(torch.stack([g.out_src, g.out_dst], 1))
    k4 = g.grow(tri)
    n_k5 = g.grow(k4, count=True)
    d = g.degree
    t_v = torch.bincount(tri.flatten(), minlength=g.v)
    # triangles on each oriented edge: its three edges point up the ranks
    pairs = torch.cat([tri[:, [0, 1]], tri[:, [0, 2]], tri[:, [1, 2]]])
    t_e = torch.bincount(torch.searchsorted(g.out_keys, pairs[:, 0] * g.v + pairs[:, 1]),
                         minlength=g.out_keys.numel())
    n_t, n_k4 = tri.shape[0], k4.shape[0]
    wedges = int((d * (d - 1) // 2).sum())
    tailed = int((t_v * (d - 2)).sum())
    diamond = int((t_e * (t_e - 1) // 2).sum()) - 6 * n_k4
    chain = wedges - 3 * n_t
    return {"triangle": n_t, "4-clique": n_k4, "5-clique": n_k5,
            "three-chain": chain, "three-chain-induced": chain,
            "tailed-triangle": tailed, "diamond": diamond,
            "paw": tailed - 4 * diamond - 12 * n_k4}
