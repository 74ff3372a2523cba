"""Padded CSR graph on torch tensors (the paper's S_CSR register file, §III-A).

The CSR offset register keeps its meaning: for every vertex v, the number
of neighbours smaller than v (the position of the first neighbour larger
than v), which serves symmetry breaking.

  * ``indices`` is SENTINEL-padded to a LANE multiple with at least one pad
    slot, so a window gather starting at any row end stays in bounds.
  * Every neighbour list is sorted ascending (all stream ops need it).
  * ``degree_buckets`` groups vertices by power-of-two capacity.

The graph is built on the host with numpy and moved to a device once with
``CSRGraph.to``. ``from_reference_arrays`` / ``to_numpy`` carry a graph in
and out as plain numpy arrays, so one graph can feed two implementations.

Value plane (the paper's SVPU, §IV-E): ``edge_values`` is an optional f32
tensor aligned index for index with ``indices``: entry i is the weight of
the directed edge whose destination is ``indices[i]`` (0.0 on padding).
``build_csr`` carries caller weights through the same self-loop drop,
mirror, dedup and lexsort permutation the keys take; ``padded_value_rows``
is the value twin of ``padded_rows``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.stream import LANE, SENTINEL, round_capacity

_FIELDS = ("indptr", "indices", "offsets", "degrees")


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row graph; all neighbour lists sorted ascending."""

    indptr: torch.Tensor    # (V+1,) int32
    indices: torch.Tensor   # (E_pad,) int32, SENTINEL-padded to LANE multiple
    offsets: torch.Tensor   # (V,)   int32: first idx in N(v) with neighbour > v
    degrees: torch.Tensor   # (V,)   int32
    # optional value plane: (E_pad,) f32 aligned with ``indices`` (0.0 pad)
    edge_values: torch.Tensor | None = None
    num_vertices: int = 0
    num_edges: int = 0
    max_degree: int = 0

    @property
    def padded_max_degree(self) -> int:
        return round_capacity(self.max_degree)

    @property
    def weighted(self) -> bool:
        return self.edge_values is not None

    @functools.cached_property
    def edge_keys(self) -> torch.Tensor:
        """(E,) int64 ``src · 2^31 + dst`` of every directed edge in CSR
        order: one sorted array, so a single ``torch.searchsorted`` finds
        the lower bound of a key inside any vertex's window (keys are
        < 2^31). Built at first use and kept for the graph's lifetime."""
        src = torch.repeat_interleave(
            torch.arange(self.num_vertices, device=self.device),
            (self.indptr[1:] - self.indptr[:-1]).long(), output_size=self.num_edges)
        return (src << 31) + self.indices[: self.num_edges].long()

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "CSRGraph":
        """The same graph with every tensor on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in _FIELDS}
        if self.edge_values is not None:
            moved["edge_values"] = self.edge_values.to(device)
        return dataclasses.replace(self, **moved)


def build_csr(edges: np.ndarray, num_vertices: int | None = None,
              undirected: bool = True,
              edge_values: np.ndarray | None = None) -> CSRGraph:
    """Build a CPU CSRGraph from an (M, 2) int edge array.

    Self-loops and duplicate edges are removed; for ``undirected`` graphs both
    directions are materialised. ``edge_values`` (optional, (M,) float) rides
    the same permutation as the keys, so value i belongs to directed edge i
    of the finished CSR.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    values = None
    if edge_values is not None:
        values = np.asarray(edge_values, dtype=np.float32).reshape(-1)
        if values.shape[0] != edges.shape[0]:
            raise ValueError(f"edge_values has {values.shape[0]} entries for "
                             f"{edges.shape[0]} edges")
    if num_vertices is None:
        num_vertices = int(edges.max()) + 1 if edges.size else 0
    keep = edges[:, 0] != edges[:, 1]                          # drop self loops
    edges = edges[keep]
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    key = edges[:, 0] * np.int64(num_vertices) + edges[:, 1]
    _, uniq = np.unique(key, return_index=True)
    edges = edges[uniq]
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    if values is not None:
        values = values[keep]
        if undirected:
            values = np.concatenate([values, values])
        values = values[uniq][order]

    src, dst = edges[:, 0], edges[:, 1]
    degrees = np.bincount(src, minlength=num_vertices).astype(np.int32)
    indptr = np.zeros(num_vertices + 1, dtype=np.int32)
    np.cumsum(degrees, out=indptr[1:])
    num_edges = int(edges.shape[0])

    e_pad = round_capacity(num_edges + 1)  # +1: a window starting at E stays in-bounds
    indices = np.full(e_pad, SENTINEL, dtype=np.int32)
    indices[:num_edges] = dst.astype(np.int32)
    # with no self-loops, first index with neighbour > v == |{w < v}|
    offsets = np.bincount(src[dst < src], minlength=num_vertices).astype(np.int32)
    arrays = dict(indptr=indptr, indices=indices, offsets=offsets, degrees=degrees)
    if values is not None:
        arrays["edge_values"] = np.zeros(e_pad, dtype=np.float32)
        arrays["edge_values"][:num_edges] = values
    return from_reference_arrays(
        arrays, num_vertices=int(num_vertices), num_edges=num_edges,
        max_degree=int(degrees.max()) if num_vertices else 0, device="cpu")


def from_reference_arrays(arrays: dict[str, np.ndarray], num_vertices: int,
                          num_edges: int, max_degree: int,
                          device="cuda") -> CSRGraph:
    """CSRGraph from the four CSR arrays of a graph held elsewhere (for
    example the JAX package's ``CSRGraph`` fields, taken as numpy arrays),
    plus its ``edge_values`` f32 plane when ``arrays`` holds one."""
    missing = [f for f in _FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing CSR arrays: {missing}")
    tensors = {f: torch.from_numpy(np.array(arrays[f], dtype=np.int32)).to(device)
               for f in _FIELDS}
    if arrays.get("edge_values") is not None:
        tensors["edge_values"] = torch.from_numpy(
            np.array(arrays["edge_values"], dtype=np.float32)).to(device)
    return CSRGraph(**tensors, num_vertices=int(num_vertices),
                    num_edges=int(num_edges), max_degree=int(max_degree))


def to_numpy(g: CSRGraph) -> dict[str, np.ndarray]:
    """The four CSR arrays, and ``edge_values`` on a weighted graph, as host
    numpy arrays (inverse of ``from_reference_arrays``)."""
    out = {f: getattr(g, f).cpu().numpy() for f in _FIELDS}
    if g.edge_values is not None:
        out["edge_values"] = g.edge_values.cpu().numpy()
    return out


def with_edge_values(g: CSRGraph, values: np.ndarray) -> CSRGraph:
    """Attach a value plane to a graph: ``values`` is (num_edges,) float,
    value i belonging to the i-th directed edge in CSR order
    (``edge_list(g)``). Returns a new graph sharing every key tensor."""
    values = np.asarray(values, dtype=np.float32).reshape(-1)
    if values.shape[0] != g.num_edges:
        raise ValueError(f"need {g.num_edges} edge values, got {values.shape[0]}")
    vals_pad = np.zeros(g.indices.shape[0], dtype=np.float32)
    vals_pad[: g.num_edges] = values
    return dataclasses.replace(g, edge_values=torch.from_numpy(vals_pad).to(g.device))


def _gather_rows(indptr: torch.Tensor, src: torch.Tensor, vs: torch.Tensor,
                 cap: int, pad):
    """(rows, lengths): row i holds ``src[indptr[v] : indptr[v] + cap]`` for
    v = vs[i], ``pad`` past the vertex's degree. Window indices are clamped
    into ``src``, so the window past the last vertex stays in bounds."""
    vs = vs.long()
    starts = indptr[vs].long()
    lens = indptr[vs + 1].long() - starts
    col = torch.arange(cap, dtype=torch.int64, device=vs.device)
    idx = (starts[:, None] + col[None, :]).clamp_(0, src.shape[0] - 1)
    return torch.where(col[None, :] < lens[:, None], src[idx], pad), lens


def csr_rows(indptr: torch.Tensor, indices: torch.Tensor, vs: torch.Tensor,
             cap: int, values: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the CSR rows of a vertex batch into a (B, cap) matrix.

    Row i holds ``indices[indptr[v] : indptr[v] + min(deg(v), cap)]`` for
    v = vs[i], SENTINEL-padded — or, given ``values`` (aligned with
    ``indices``), the f32 values beside those keys, 0.0-padded. The plain
    version of the kernels' CSR row operand (``kernels.intersect``)."""
    if values is None:
        return _gather_rows(indptr, indices, vs, cap, SENTINEL)[0]
    return _gather_rows(indptr, values, vs, cap, 0.0)[0]


def padded_rows(g: CSRGraph, vs: torch.Tensor, cap: int):
    """Gather the neighbour lists of a vertex batch into a (B, cap) matrix.

    Returns (keys, lengths): keys SENTINEL-padded/truncated to ``cap``, both
    int32 on the graph's device. Window indices are clamped into
    ``indices``, so the window past the last vertex reads SENTINEL padding.
    """
    rows, lens = _gather_rows(g.indptr, g.indices, vs, cap, SENTINEL)
    return rows, torch.clamp(lens, max=cap).to(torch.int32)


def padded_value_rows(g: CSRGraph, vs: torch.Tensor, cap: int) -> torch.Tensor:
    """Value twin of ``padded_rows``: each vertex's edge values as a
    (B, cap) f32 matrix, 0.0 where the key row holds SENTINEL padding."""
    if g.edge_values is None:
        raise ValueError("graph has no edge_values (see with_edge_values)")
    return _gather_rows(g.indptr, g.edge_values, vs, cap, 0.0)[0]


def degree_buckets(g: CSRGraph, base: int = LANE) -> list[tuple[int, np.ndarray]]:
    """Host-side: group vertices into power-of-two capacity buckets.

    Returns [(cap, vertex_ids), ...] with cap ∈ {base, 2·base, 4·base, ...},
    covering every vertex with degree > 0. Padding waste per bucket ≤ 2×.
    """
    deg = g.degrees.cpu().numpy()
    out: list[tuple[int, np.ndarray]] = []
    cap = base
    lo = 1
    while lo <= max(int(deg.max()) if deg.size else 0, 1):
        sel = np.nonzero((deg >= lo) & (deg <= cap))[0]
        if sel.size:
            out.append((cap, sel.astype(np.int32)))
        lo = cap + 1
        cap *= 2
    return out


def edge_list(g: CSRGraph) -> np.ndarray:
    """(E, 2) directed edge array (host), in CSR order."""
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()[: g.num_edges]
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int32),
                    np.diff(indptr).astype(np.int64))
    return np.stack([src, indices], axis=1)
