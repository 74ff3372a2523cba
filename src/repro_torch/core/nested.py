"""S_NESTINTER — the paper's CISC nested-intersection instruction (§III-B, §IV-F).

The counterpart of ``repro.core.nested``. Semantics: given key stream
S = [s_0..s_k] over a CSR graph loaded with S_CSR,
C = Σ_i |S ∩ N(s_i)|.

The paper's hardware translates this into a µop sequence (S_READ/S_INTER.C/
S_FREE per key) buffered in a translation buffer. Here the translation is
one batched intersection count of S against every N(s_i), through the count
kernel's CSR form (``ops.xinter_count_csr``): row i's reference is read from
the graph's CSR where it lies, as the engine's count leaves read theirs, so
no (|S|, cap) matrix of neighbour rows is gathered. The base is S itself,
one row per key. A SENTINEL slot of S reads vertex 0's row under bound 0,
which kills its row. A CPU stream takes the wrapper's plain version
(``graph.csr.csr_rows`` gathers the rows ``padded_rows`` would, then
``batch_inter_count``).
"""
from __future__ import annotations

import torch

from .stream import SENTINEL, Stream, round_capacity


def s_nestinter(g, s: Stream, cap: int | None = None,
                bound_by_key: bool = False) -> torch.Tensor:
    """C = Σ_{i<len(S)} |S ∩ N(s_i)| (optionally bounded by s_i per key), an
    exact 0-d int32 sum on the stream's device; ``g`` lives there too.

    ``bound_by_key=True`` is a beyond-paper extension: each inner intersection
    is bounded by its own key (counts only common neighbors < s_i), which is
    the inner loop of symmetry-broken clique counting.
    """
    from repro_torch.kernels.ops import xinter_count_csr  # deferred: kernels sit above core
    cap = round_capacity(cap if cap is not None else g.max_degree)
    valid = s.keys != SENTINEL
    vb = torch.where(valid, s.keys, 0)
    bounds = torch.where(valid, s.keys if bound_by_key else torch.full_like(s.keys, SENTINEL), 0)
    a = s.keys.expand(s.capacity, s.capacity).contiguous()
    counts = xinter_count_csr(g.indptr, g.indices, vb, cap, a=a, bounds=bounds)
    return counts.sum(dtype=torch.int32)
