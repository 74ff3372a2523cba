"""Stream-intersection entry points used by the engine.

The counterparts of ``repro.kernels.ops``, minus ``backend``: the device of
the tensors picks the path (a CUDA tensor launches the hand-written kernel,
a CPU tensor takes its plain torch version; see ``kernels.intersect``).
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import (batch_compact_scan, batch_level_agg,
                                    batch_level_compact, batch_level_count)
from repro_torch.core.stream import SENTINEL

from .bitmap import bitmap_and_count, keys_to_bitmap
from .compact import compact_rows
from .intersect import (expand_items, intersect_count, intersect_count_csr,
                        intersect_count_worklist, intersect_expand, intersect_expand_csr,
                        intersect_mark, intersect_mark_csr, intersect_multi,
                        intersect_multi_agg, intersect_multi_agg_csr,
                        intersect_multi_count_worklist, intersect_multi_csr,
                        intersect_multi_mark_csr, intersect_sub_count_csr)
from .svinter import vinter, vinter_grid


def xinter_count(a, b, bounds=None, lbounds=None):
    """Batched bounded S_INTER.C (``lbounds`` = exclusive lower bound)."""
    return intersect_count(a, b, bounds, lbounds)


def xinter_count_csr(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                     bounds=None, lbounds=None):
    """``xinter_count`` with B's rows, and a fresh base's, read from the CSR
    (vertex ids ``vb`` / ``va`` at their caps; a carried base as padded
    rows ``a``): the count leaf, with no gathered rows in device memory."""
    return intersect_count_csr(indptr, indices, vb, cap_b, a, va, cap_a, bounds,
                               lbounds)


def xcount_worklist(indptr, indices, rows2, src, verts2, lo: int, m: int, cap_a: int,
                    cap_b: int, total, sub: bool = False):
    """A carried INTER (``sub``: SUB) count leaf over the chunk [lo, lo + m)
    of its parent's compacted worklist ``(rows2, src, verts2)``, read in
    place: the base row of item i is ``rows2[src[i], :cap_a]``, its one
    reference and its upper bound the vertex ``verts2[i]``; the count is
    added to the 0-d int64 ``total``. One launch, nothing sliced."""
    return intersect_count_worklist(indptr, indices, rows2, src, verts2, lo, m, cap_a,
                                    cap_b, total, sub)


def xinter(a, b, bounds=None, out_cap: int | None = None, lbounds=None):
    """Batched bounded S_INTER -> (rows (B, out_cap), counts (B,)),
    ``out_cap`` defaulting to min(cap_a, cap_b): the mark kernel gives the
    survivors, the compact-rows kernel front-packs them. On the CPU the two
    plain versions compose to ``core.batch.batch_inter``."""
    cap = out_cap or min(a.shape[1], b.shape[1])
    return compact_rows(a, intersect_mark(a, b, bounds, lbounds), cap)


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


def xinter_compact_csr(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                       bounds=None, out_cap: int | None = None,
                       out_items: int | None = None, lbounds=None):
    """``xinter_compact`` with B's rows, and a fresh base's, read from the
    CSR (vertex ids ``vb`` / ``va`` at their caps; a carried base as padded
    rows ``a``): the engine's INTER expand level, the same six outputs with
    no torch scatter. The expand kernel packs each row's survivors and
    counts them, an exclusive ``torch.cumsum`` of the B counts gives each
    row's first item, and the items kernel writes ``src`` / ``verts``.
    ``out_cap`` (default min(cap_a, cap_b)) must not cut a row."""
    cap_a = a.shape[1] if a is not None else cap_a
    cap = out_cap or min(cap_a, cap_b)
    items = out_items or vb.shape[0] * cap
    rows, counts = intersect_expand_csr(indptr, indices, vb, cap_b, cap, a, va, cap_a,
                                        bounds, lbounds)
    offs = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    src, verts = expand_items(rows, counts, offs, items)
    return rows, counts, src, verts, counts.sum(dtype=torch.int32), counts.max()


def xmark(a, b):
    """Batched membership mask: mark[i, s] = A_i[s] ∈ B_i (live slots only),
    bool. The ``fused_level=False`` level composition ANDs one per
    INTER/SUB reference; the mark kernel runs unbounded, so the same mark
    serves INTER (mask) and SUB (~mask), and the caller applies the bounds."""
    return intersect_mark(a, b) > 0


def xmark_csr(indptr, indices, a, vb, cap_b):
    """``xmark`` with B's rows read from the CSR (vertex ids ``vb`` at
    ``cap_b``) over padded base rows ``a``: the mask a ``fused_level=False``
    or host-path level ANDs per reference."""
    return intersect_mark_csr(indptr, indices, a, vb, cap_b)


def _sub_window(a, bounds, lbounds):
    """The complement's value window (lbound, bound) as a keep mask.

    SUB bounds live outside the mark kernel: its bound operand masks
    *matches*, which is the wrong polarity for a complement (a key outside
    the window must be dropped whether or not it matched)."""
    keep = a != SENTINEL
    if bounds is not None:
        keep = keep & (a < bounds[:, None])
    if lbounds is not None:
        keep = keep & (a > lbounds[:, None])
    return keep


def _sub_kernel_keep(a, b, bounds, lbounds):
    # the mark kernel runs UNBOUNDED here (see _sub_window on polarity)
    return (intersect_mark(a, b) == 0) & _sub_window(a, bounds, lbounds)


def xsub(a, b, bounds=None, out_cap: int | None = None, lbounds=None):
    """Batched bounded S_SUB -> (rows (B, out_cap), counts (B,)), ``out_cap``
    defaulting to cap_a: the mark kernel, unbounded, gives the complement's
    keep row, the compact-rows kernel front-packs it. On the CPU the two
    plain versions compose to ``core.batch.batch_sub``."""
    return compact_rows(a, _sub_kernel_keep(a, b, bounds, lbounds), out_cap or a.shape[1])


def xsub_count(a, b, bounds=None, lbounds=None):
    """Batched bounded S_SUB.C:
    counts[i] = |{k ∈ A_i \\ B_i : lbounds[i] < k < bounds[i]}|."""
    return _sub_kernel_keep(a, b, bounds, lbounds).sum(dim=1, dtype=torch.int32)


def xsub_count_csr(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                   bounds=None, lbounds=None):
    """``xsub_count`` with B's rows, and a fresh base's, read from the CSR
    (a carried base as padded rows ``a``): the SUB count leaf, one launch of
    the count kernel's SUB form and no mark."""
    return intersect_sub_count_csr(indptr, indices, vb, cap_b, a, va, cap_a, bounds,
                                   lbounds)


def xsub_compact(a, b, bounds=None, out_cap: int | None = None,
                 out_items: int | None = None, lbounds=None):
    """Fused bounded S_SUB + worklist compaction — ``xinter_compact``'s twin
    for SUB levels (induced non-edge constraints), same output contract.
    ``out_cap`` defaults to cap_a: a complement can keep all of A."""
    cap = out_cap or a.shape[1]
    items = out_items or a.shape[0] * cap
    return batch_compact_scan(a, _sub_kernel_keep(a, b, bounds, lbounds), cap, items)


def xsub_compact_csr(indptr, indices, a, vb, cap_b, bounds=None, out_cap: int | None = None,
                     out_items: int | None = None, lbounds=None):
    """``xsub_compact`` with B's rows read from the CSR (vertex ids ``vb`` at
    ``cap_b``) over padded base rows ``a``: the mark kernel applies the
    window and writes the keep row as bool, the scan compacts it."""
    cap = out_cap or a.shape[1]
    items = out_items or a.shape[0] * cap
    keep = intersect_mark_csr(indptr, indices, a, vb, cap_b, True, bounds, lbounds)
    return batch_compact_scan(a, keep, cap, items)


def xlevel_count(a, bs, pol, bounds=None, lbounds=None, excludes=None):
    """Fused multi-operand level count — one launch for a whole INTER/SUB
    µop sequence:

    counts[i] = |{k ∈ A_i : k ∈ B^r_i ∀ INTER r, k ∉ B^r_i ∀ SUB r,
                  lbounds[i] < k < bounds[i], k ∉ excludes[i]}|

    ``bs`` is the (k, B, cap_b) reference stack, ``pol`` the INTER-first
    polarity tuple. ``pol = ()`` (a window/injectivity-only level) is the
    plain torch form on every device, as in the JAX package: there is no
    stream work for a kernel to fuse, so this is the design, not a fallback.
    """
    if not pol:
        return batch_level_count(a, bs, pol, bounds, lbounds, excludes)
    return intersect_multi(a, bs, pol, bounds, lbounds, excludes)[1]


def xlevel_compact(a, bs, pol, bounds=None, out_cap: int | None = None,
                   out_items: int | None = None, lbounds=None, excludes=None):
    """Fused multi-operand level + worklist compaction: the k-reference
    kernel gives the keep mark, ``batch_compact_scan`` the six outputs of
    ``xinter_compact``'s contract. ``pol = ()`` as in ``xlevel_count``."""
    cap = out_cap or a.shape[1]
    items = out_items or a.shape[0] * cap
    if not pol:
        return batch_level_compact(a, bs, pol, bounds, lbounds, excludes,
                                   cap, items)
    mark, _ = intersect_multi(a, bs, pol, bounds, lbounds, excludes)
    return batch_compact_scan(a, mark > 0, cap, items)


def xlevel_count_csr(indptr, indices, vbs, caps_b, pol, a=None, va=None, cap_a=None,
                     bounds=None, lbounds=None, excludes=None):
    """``xlevel_count`` for k >= 1 references read from the CSR (the (k, B)
    ids ``vbs`` at ``caps_b``), the base as padded rows ``a`` or CSR rows of
    ``va`` at ``cap_a``: one launch of the k-reference kernel, no mark."""
    return intersect_multi_csr(indptr, indices, vbs, caps_b, pol, a, va, cap_a, bounds,
                               lbounds, excludes)


def xlevel_count_worklist(indptr, indices, rows2, src, verts2, cols, lo: int, m: int,
                          total, base, cap_a: int, refs, caps_b, pol, ub=(), lb=(),
                          exclude=()):
    """A general count leaf over the chunk [lo, lo + m) of its parent's
    compacted worklist ``(src, verts2)``, read in place: its vertices are
    the parent's new vertex (column ``len(cols)``, ``verts2[i]``) and the
    columns the parent forwards (``cols[c][src[i]]``); its base the CSR row
    of column ``base`` at ``cap_a`` (None: the carried ``rows2[src[i],
    :cap_a]``), its references the CSR rows of columns ``refs`` at
    ``caps_b`` with polarity ``pol``, its bounds and excludes those
    columns' vertices. The count is added to the 0-d int64 ``total``. One
    launch of the k-reference kernel, nothing sliced; the plain form off
    the card."""
    return intersect_multi_count_worklist(indptr, indices, rows2, src, verts2, cols, lo, m,
                                          total, base, cap_a, refs, caps_b, pol, ub, lb,
                                          exclude)


def xlevel_compact_csr(indptr, indices, a, vbs, caps_b, pol, bounds=None,
                       out_cap: int | None = None, out_items: int | None = None,
                       lbounds=None, excludes=None):
    """``xlevel_compact`` for k >= 1 references read from the CSR over
    padded base rows ``a``: the k-reference kernel's bool keep row, then
    ``batch_compact_scan``."""
    cap = out_cap or a.shape[1]
    items = out_items or a.shape[0] * cap
    keep = intersect_multi_mark_csr(indptr, indices, a, vbs, caps_b, pol, bounds, lbounds,
                                    excludes)
    return batch_compact_scan(a, keep, cap, items)


def xlevel_agg(a, bs, pol, a_vals, b_vals, scale, op: str = "sum", bounds=None,
               lbounds=None, excludes=None):
    """Fused multi-operand level count + SVPU value aggregate (§IV-E) ->
    (counts, vals) in one launch of the value-lane kernel.

    Membership as in ``xlevel_count``; each kept slot carries
    ``a_vals · Π_{INTER r} matched_val_r · scale[row]`` and ``vals[i]``
    reduces row i's kept slots with ``op`` ('sum' / 'max' / 'min'; the op's
    identity for an empty row). ``b_vals`` is the (k, B, cap_b) value stack
    aligned with ``bs`` (0.0 where keys are SENTINEL). ``pol = ()`` is the
    plain torch form on every device, as in ``xlevel_count``."""
    if not pol:
        return batch_level_agg(a, bs, pol, a_vals, b_vals, scale, op, bounds,
                               lbounds, excludes)
    _, counts, vals = intersect_multi_agg(a, bs, pol, a_vals, b_vals, scale, op,
                                          bounds, lbounds, excludes)
    return counts, vals


def xlevel_agg_csr(indptr, indices, edge_values, vbs, caps_b, pol, scale,
                   op: str = "sum", a=None, va=None, cap_a=None, a_vals=None,
                   bounds=None, lbounds=None, excludes=None):
    """``xlevel_agg`` for k >= 1 references read from the CSR: the (k, B)
    reference ids ``vbs`` at ``caps_b``, their values from ``edge_values``;
    the base as padded rows ``a`` (``a_vals``, None for 1.0) or CSR rows of
    ``va`` with their own values -> (counts, vals), one launch of the
    value-lane kernel and no mark."""
    return intersect_multi_agg_csr(indptr, indices, edge_values, vbs, caps_b, pol,
                                   scale, op, a, va, cap_a, a_vals, bounds, lbounds,
                                   excludes)


def xvinter(a_keys, a_vals, b_keys, b_vals, op: str = "mac"):
    """Batched S_VINTER (SVPU, §IV-E): per row, the op-sum over value pairs
    of intersected keys ('mac' Σ va·vb, a sparse dot; 'max' / 'min' Σ of the
    pair's max / min) — the entry ``sparse.ttv`` goes through."""
    return vinter(a_keys, a_vals, b_keys, b_vals, op)


def xvinter_grid(a_keys, a_vals, b_keys, b_vals, op: str = "mac"):
    """``xvinter`` over every (A row, B row) pair of two stacks -> (nr, nc),
    no pair's rows copied — the entry ``sparse.spmm`` goes through, once per
    (row block, column block)."""
    return vinter_grid(a_keys, a_vals, b_keys, b_vals, op)


def xvinter_mac(a_keys, a_vals, b_keys, b_vals, op: str = "mac"):
    """``xvinter`` under the JAX package's older name."""
    return xvinter(a_keys, a_vals, b_keys, b_vals, op)


def xbitmap_count(a_words, b_words):
    """Bitmap-path intersection count (the beyond-paper dense path):
    per row, the popcount of the AND of two ``keys_to_bitmap`` rows."""
    return bitmap_and_count(a_words, b_words)


__all__ = ["xinter", "xinter_count", "xinter_compact", "xmark", "xsub_count",
           "xsub_compact", "xlevel_count", "xlevel_compact", "xlevel_agg",
           "xvinter", "xvinter_mac", "xbitmap_count", "keys_to_bitmap"]
