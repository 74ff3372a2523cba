"""Stream-intersection entry points used by the engine.

The counterparts of ``repro.kernels.ops``, minus ``backend``: the device of
the tensors picks the path (a CUDA tensor launches the hand-written kernel,
a CPU tensor takes its plain torch version; see ``kernels.intersect``).
"""
from __future__ import annotations

from repro_torch.core.batch import batch_compact_scan

from .intersect import intersect_count, intersect_expand


def xinter_count(a, b, bounds=None, lbounds=None):
    """Batched bounded S_INTER.C (``lbounds`` = exclusive lower bound)."""
    return intersect_count(a, b, bounds, lbounds)


def xinter_compact(a, b, bounds=None, out_cap: int | None = None,
                   out_items: int | None = None, lbounds=None):
    """Fused bounded S_INTER + worklist compaction, device-resident.

    One kernel launch marks the survivors and counts them per row; the
    prefix-sum scatter (``batch_compact_scan``, torch ops) builds everything
    the next wavefront level needs:

      rows   (B, out_cap)    per-source survivor streams S_{l+1}
      counts (B,)            per-source survivor counts
      src    (out_items,)    compacted item -> source row index
      verts  (out_items,)    compacted item extension vertex (0 = padding)
      total  ()              live item count   (host-synced at level bounds)
      maxc   ()              max survivor count (sizes the next capacity)
    """
    cap = out_cap or min(a.shape[1], b.shape[1])
    items = out_items or a.shape[0] * cap
    mark, counts = intersect_expand(a, b, bounds, lbounds)
    rows, _, src, verts, total, maxc = batch_compact_scan(a, mark > 0, cap, items)
    return rows, counts, src, verts, total, maxc
