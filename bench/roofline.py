"""The least time a pass's work could take on the card, from the graph alone.

Graph mining compares integers; no published integer-compare peak bounds
it sooner than memory, so the bound is bytes over the card's memory
bandwidth. A pass must read the resident CSR once for each call of its
traffic (offsets and neighbour ids at 4 bytes, the least width that holds
the ids of a graph of under 2**31 vertices) and write each answer once
(8 bytes, an int64 count). Whatever the program reads again, or caches, is
no part of the bound: it reads the same whatever implements the queries.
"""
from __future__ import annotations

ID_BYTES = 4
ANSWER_BYTES = 8

# published peaks, by a substring of torch.cuda.get_device_name(): NVIDIA's
# H100 data sheet (SXM part, 700 W): 3.35 TB/s of HBM3
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}


def csr_bytes(num_vertices: int, directed_edges: int) -> int:
    """Bytes of a CSR of ``num_vertices`` offsets (+1) and
    ``directed_edges`` neighbour ids (each undirected edge twice)."""
    return ID_BYTES * (num_vertices + 1) + ID_BYTES * directed_edges


def pass_bytes(num_vertices: int, directed_edges: int, calls: list[int]) -> int:
    """The least bytes a pass moves: ``calls`` holds the answers of each
    call of the pass (1 for ``count``, the batch size for ``count_many``)."""
    return sum(csr_bytes(num_vertices, directed_edges) + ANSWER_BYTES * n for n in calls)


def peak(device_name: str) -> dict | None:
    """The published peaks of the card, or None for a card not in the table."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def least_seconds(num_vertices: int, directed_edges: int, calls: list[int],
                  device_name: str) -> float | None:
    """The memory bound of a pass on ``device_name``, or None off the table."""
    p = peak(device_name)
    if p is None:
        return None
    return pass_bytes(num_vertices, directed_edges, calls) / p["hbm_bytes_per_s"]
