"""Batched stream ops on torch tensors — the plain versions of the kernels.

Rows are SENTINEL-padded sorted int32 matrices (B, cap). ``bounds`` is a
per-row exclusive upper bound (SENTINEL = unbounded, the R3 operand),
``lbounds`` a per-row exclusive lower bound (-1 = unbounded). Membership is
a batched binary search (``torch.searchsorted``), O(cap_a · log cap_b) per
row. These functions run on any device; the CUDA kernels in
``repro_torch.kernels`` are held against them.

Compaction (``batch_compact_scan``) is a segmented prefix-sum scatter,
O(B·cap), no sort. It is correct under the **monotonicity precondition**:
base rows are sorted and the keep mask selects without reordering, so
survivor j goes to slot ``cumsum(keep)[j] - 1`` of its row, and items come
out in row-major (i, j) order. Survivors past ``out_cap`` / ``out_items``
are dropped: they are scattered into one dump slot past the end of a
buffer that is then sliced off (an out-of-range scatter index is an error
in torch, not a drop).
"""
from __future__ import annotations

import torch

from .stream import SENTINEL


def _row_membership(rows_a: torch.Tensor, rows_b: torch.Tensor) -> torch.Tensor:
    """mark[i, s] = A_i[s] ∈ B_i and A_i[s] != SENTINEL."""
    idx = torch.searchsorted(rows_b, rows_a)
    hit = rows_b.gather(1, idx.clamp_(max=rows_b.shape[1] - 1)) == rows_a
    return hit & (rows_a != SENTINEL)


def _bounds(rows_a: torch.Tensor, bounds) -> torch.Tensor:
    if bounds is None:
        return torch.full((rows_a.shape[0],), SENTINEL, dtype=torch.int32,
                          device=rows_a.device)
    return bounds


def _lbounds(rows_a: torch.Tensor, lbounds) -> torch.Tensor:
    """Per-row exclusive lower bound; -1 = unbounded (vertex ids are >= 0)."""
    if lbounds is None:
        return torch.full((rows_a.shape[0],), -1, dtype=torch.int32,
                          device=rows_a.device)
    return lbounds


def inter_keep(rows_a, rows_b, bounds=None, lbounds=None) -> torch.Tensor:
    """keep[i, s] = A_i[s] ∈ B_i and lbounds[i] < A_i[s] < bounds[i]."""
    ub, lb = _bounds(rows_a, bounds), _lbounds(rows_a, lbounds)
    return _row_membership(rows_a, rows_b) & (rows_a < ub[:, None]) \
        & (rows_a > lb[:, None])


def _scan_compact_parts(rows_a: torch.Tensor, keep: torch.Tensor, out_cap: int):
    """Shared segmented-prefix-sum core: (rows, counts, keep, pos, row).

    ``pos`` is each survivor's slot in its row stream, ``row`` the row index
    grid; the item scatter in ``batch_compact_scan`` reuses both."""
    B, cap = rows_a.shape
    dev = rows_a.device
    keep = keep & (rows_a != SENTINEL)
    counts = keep.sum(dim=1, dtype=torch.int32)
    pos = keep.cumsum(dim=1, dtype=torch.int32) - 1
    row = torch.arange(B, dtype=torch.int64, device=dev)[:, None].expand(B, cap)
    dump = B * out_cap
    slot = torch.where(keep & (pos < out_cap), row * out_cap + pos, dump)
    rows = torch.full((dump + 1,), SENTINEL, dtype=torch.int32, device=dev)
    rows.scatter_(0, slot.reshape(-1), rows_a.reshape(-1))
    return rows[:dump].view(B, out_cap), counts, keep, pos, row


def batch_compact_rows(rows_a: torch.Tensor, keep: torch.Tensor, out_cap: int):
    """Per-row survivor streams from a keep mask, by prefix-sum scatter ->
    (rows (B, out_cap) front-packed SENTINEL-padded, counts (B,)).

    Survivors keep their order (sorted input => sorted output); a kept
    SENTINEL slot never counts; counts are not cut at ``out_cap``, rows are.
    The plain version of the compact-rows kernel, and the O(B·cap)
    replacement for the masked-sort tail (``torch.sort(where(keep, a,
    SENTINEL))[:, :out_cap]``), whose rows and counts it equals."""
    rows, counts, _, _, _ = _scan_compact_parts(rows_a, keep, out_cap)
    return rows, counts


def compact_indices_scan(ok: torch.Tensor):
    """Order-preserving index compaction: the positions of the set entries
    of ``ok`` (1-D bool), front-packed with 0 past the live count, and the
    live count (int32) — the residual worklist pack. The scatter of the
    dropped positions lands in a dump slot past the end."""
    n = ok.shape[0]
    pos = ok.cumsum(0, dtype=torch.int32) - 1
    tgt = torch.where(ok, pos, n).long()
    order = torch.zeros(n + 1, dtype=torch.int32, device=ok.device)
    order.scatter_(0, tgt, torch.arange(n, dtype=torch.int32, device=ok.device))
    return order[:n], ok.sum(dtype=torch.int32)


def batch_compact_scan(rows_a: torch.Tensor, keep: torch.Tensor, out_cap: int,
                       out_items: int):
    """Fused survivor-stream + worklist compaction from one keep mask.

    Output contract (``kernels.ops.xinter_compact``):

      rows   (B, out_cap)   front-packed survivor streams
      counts (B,)           per-row survivor counts
      src    (out_items,)   item -> source row   (0 past total)
      verts  (out_items,)   item extension vertex (0 past total)
      total  ()             live item count
      maxc   ()             max per-row survivor count
    """
    rows, counts, keep, pos, row = _scan_compact_parts(rows_a, keep, out_cap)
    offs = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    ipos = offs[:, None] + pos
    ipos = torch.where(keep & (ipos < out_items), ipos, out_items).reshape(-1).long()
    dev = rows_a.device
    src = torch.zeros(out_items + 1, dtype=torch.int32, device=dev)
    src.scatter_(0, ipos, row.reshape(-1).to(torch.int32))
    verts = torch.zeros(out_items + 1, dtype=torch.int32, device=dev)
    verts.scatter_(0, ipos, rows_a.reshape(-1))
    return (rows, counts, src[:out_items], verts[:out_items],
            counts.sum(dtype=torch.int32), counts.max())


def batch_inter_count(rows_a, rows_b, bounds=None, lbounds=None) -> torch.Tensor:
    """counts[i] = |{k in A_i ∩ B_i : lbounds[i] < k < bounds[i]}| —
    batched S_INTER.C."""
    return inter_keep(rows_a, rows_b, bounds, lbounds).sum(dim=1, dtype=torch.int32)


def batch_inter_compact(rows_a, rows_b, bounds, out_cap: int, out_items: int,
                        lbounds=None):
    """Fused batched S_INTER + worklist compaction — one keep mask feeding
    ``batch_compact_scan``."""
    return batch_compact_scan(rows_a, inter_keep(rows_a, rows_b, bounds, lbounds),
                              out_cap, out_items)


def batch_inter(rows_a, rows_b, bounds=None, out_cap: int | None = None,
                lbounds=None):
    """Batched S_INTER -> (rows (B, out_cap), counts (B,)); ``out_cap``
    defaults to min(cap_a, cap_b), the paper's §IV-D bound on the result."""
    cap = out_cap or min(rows_a.shape[1], rows_b.shape[1])
    return batch_compact_rows(rows_a, inter_keep(rows_a, rows_b, bounds, lbounds), cap)


def batch_member_mark(rows_a: torch.Tensor, rows_b: torch.Tensor) -> torch.Tensor:
    """mark[i, s] = A_i[s] ∈ B_i (and A_i[s] live) — the plain version of the
    mark kernel run unbounded; the engine's ``fused_level=False`` path ANDs
    one of these per INTER/SUB reference into a level's keep mask."""
    return _row_membership(rows_a, rows_b)


def sub_keep(rows_a, rows_b, bounds=None, lbounds=None) -> torch.Tensor:
    """keep[i, s] = A_i[s] ∉ B_i, A_i[s] live and lbounds[i] < A_i[s] < bounds[i]."""
    ub, lb = _bounds(rows_a, bounds), _lbounds(rows_a, lbounds)
    return ~_row_membership(rows_a, rows_b) & (rows_a != SENTINEL) \
        & (rows_a < ub[:, None]) & (rows_a > lb[:, None])


def batch_sub_count(rows_a, rows_b, bounds=None, lbounds=None) -> torch.Tensor:
    """counts[i] = |{k in A_i \\ B_i : lbounds[i] < k < bounds[i]}| —
    batched S_SUB.C."""
    return sub_keep(rows_a, rows_b, bounds, lbounds).sum(dim=1, dtype=torch.int32)


def batch_sub(rows_a, rows_b, bounds=None, out_cap: int | None = None,
              lbounds=None):
    """Batched S_SUB -> (rows (B, out_cap or cap_a), counts (B,))."""
    return batch_compact_rows(rows_a, sub_keep(rows_a, rows_b, bounds, lbounds),
                              out_cap or rows_a.shape[1])


def batch_sub_compact(rows_a, rows_b, bounds, out_cap: int, out_items: int,
                      lbounds=None):
    """Fused batched S_SUB + worklist compaction: the complement's keep mask
    feeding ``batch_compact_scan``."""
    return batch_compact_scan(rows_a, sub_keep(rows_a, rows_b, bounds, lbounds),
                              out_cap, out_items)


def level_keep(rows_a, bs, pol, bounds=None, lbounds=None,
               excludes=None) -> torch.Tensor:
    """keep = window ∧ excludes ∧ (∈ B_r ∀ INTER r) ∧ (∉ B_r ∀ SUB r) for a
    level of k = len(pol) references; ``bs`` is their (k, B, cap_b) stack
    (None when k = 0), ``excludes`` a (B, E) array of injectivity keys."""
    ub, lb = _bounds(rows_a, bounds), _lbounds(rows_a, lbounds)
    keep = (rows_a != SENTINEL) & (rows_a < ub[:, None]) & (rows_a > lb[:, None])
    if excludes is not None:
        keep = keep & (rows_a[:, :, None] != excludes[:, None, :]).all(dim=2)
    for r, p in enumerate(pol):
        m = _row_membership(rows_a, bs[r])
        keep = keep & m if p else keep & ~m
    return keep


def batch_level_count(rows_a, bs, pol, bounds=None, lbounds=None,
                      excludes=None) -> torch.Tensor:
    """counts[i] = |{k ∈ A_i : all pol-signed memberships, window, excludes}|
    — a whole multi-operand level's S_*.C (k = 0: a window-only count)."""
    return level_keep(rows_a, bs, pol, bounds, lbounds, excludes) \
        .sum(dim=1, dtype=torch.int32)


def batch_level_compact(rows_a, bs, pol, bounds, lbounds, excludes,
                        out_cap: int, out_items: int):
    """Fused multi-operand level + scan compaction — ``batch_compact_scan``'s
    contract for any k-reference level."""
    return batch_compact_scan(rows_a, level_keep(rows_a, bs, pol, bounds, lbounds,
                                                 excludes), out_cap, out_items)


F32_MAX = 3.4e38   # masked-reduce identities of the value lane (finite, as
                   # in the JAX package; rounded to f32 wherever it lands)
AGG_OPS = ("sum", "max", "min")


def _matched_vals(rows_a: torch.Tensor, rows_b: torch.Tensor,
                  vals_b: torch.Tensor) -> torch.Tensor:
    """Per A-slot matched value in (B_i, V_i): vals_b at the matching key,
    0.0 on a miss or on a SENTINEL slot of A."""
    idx = torch.searchsorted(rows_b, rows_a).clamp_(max=rows_b.shape[1] - 1)
    found = (rows_b.gather(1, idx) == rows_a) & (rows_a != SENTINEL)
    return torch.where(found, vals_b.gather(1, idx), 0.0)


def level_agg(rows_a, bs, pol, a_vals, b_vals, scale, op: str = "sum",
              bounds=None, lbounds=None, excludes=None):
    """A k-reference level's keep mask and its per-row value aggregate
    (the plain version of ``intersect_multi_agg``) -> (keep, vals).

    Each kept slot carries ``a_vals · Π_{INTER r} matched_val_r · scale[row]``,
    multiplied in that order, and ``vals`` reduces the kept slots per row
    with ``op`` (sum / max / min; an empty row gives the identity 0.0 /
    -3.4e38 / +3.4e38). ``b_vals`` is the (k, B, cap_b) value stack aligned
    with ``bs`` (SUB refs' values are ignored; None when k = 0)."""
    if op not in AGG_OPS:
        raise ValueError(f"unknown SVPU aggregate {op!r}")
    keep = level_keep(rows_a, bs, pol, bounds, lbounds, excludes)
    contrib = a_vals.float()
    for r, p in enumerate(pol):
        if p:
            contrib = contrib * _matched_vals(rows_a, bs[r], b_vals[r])
    contrib = contrib * scale.float()[:, None]
    if op == "sum":
        vals = torch.where(keep, contrib, 0.0).sum(dim=1, dtype=torch.float32)
    elif op == "max":
        vals = torch.where(keep, contrib, -F32_MAX).amax(dim=1)
    else:
        vals = torch.where(keep, contrib, F32_MAX).amin(dim=1)
    return keep, vals


def batch_level_agg(rows_a, bs, pol, a_vals, b_vals, scale, op: str = "sum",
                    bounds=None, lbounds=None, excludes=None):
    """Fused multi-operand level count + SVPU value aggregate -> (counts,
    vals), ``level_agg``'s contract."""
    keep, vals = level_agg(rows_a, bs, pol, a_vals, b_vals, scale, op, bounds,
                           lbounds, excludes)
    return keep.sum(dim=1, dtype=torch.int32), vals


VINTER_OPS = ("mac", "max", "min")


def batch_vinter(rows_a, vals_a, rows_b, vals_b, op: str = "mac") -> torch.Tensor:
    """Batched S_VINTER: out[i] = Σ_{k ∈ A_i ∩ B_i} op(va, vb), op mac
    (va·vb), max or min; SENTINEL slots of A never match."""
    if op not in VINTER_OPS:
        raise ValueError(f"unknown SVPU op {op!r}")
    rows_b, vals_b = rows_b.contiguous(), vals_b.contiguous()
    idx = torch.searchsorted(rows_b, rows_a).clamp_(max=rows_b.shape[1] - 1)
    found = (rows_b.gather(1, idx) == rows_a) & (rows_a != SENTINEL)
    vb = vals_b.gather(1, idx)
    if op == "mac":
        terms = vals_a * vb
    elif op == "max":
        terms = torch.maximum(vals_a, vb)
    else:
        terms = torch.minimum(vals_a, vb)
    return torch.where(found, terms, 0.0).sum(dim=1, dtype=torch.float32)
