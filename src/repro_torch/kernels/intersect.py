"""Batched bounded sorted-set intersection — the IntersectX IU on Hopper.

Four hand-written CUDA kernels (``csrc/intersect.cu``) replace the Pallas
kernels of ``repro/kernels/intersect.py`` on the mining main path:

  ``intersect_count``   <- ``intersect_count_pallas``  -> counts (B,)
  ``intersect_expand``  <- ``intersect_expand_pallas`` -> (mark (B, cap_a),
                                                           counts (B,))
  ``intersect_mark``    <- ``intersect_mark_pallas``   -> mark (B, cap_a)
  ``intersect_multi``   <- ``intersect_multi_pallas``  -> (mark (B, cap_a),
                                                           counts (B,))
  ``intersect_multi_agg`` <- ``intersect_multi_agg_pallas`` -> (mark, counts,
                                                           vals (B,) f32)

More entries serve the engine's levels with reference rows read straight
from the graph's CSR (no gathered (B, cap) matrix in device memory), on the
same device templates and launch counters as their padded-row forms.
``expand_items`` (a second kernel of the same source, on its own counter)
turns ``intersect_expand_csr``'s rows into the level's worklist.

  ``intersect_count_csr``      the count leaf: B's rows (and a fresh base's)
                               given as vertex ids            -> counts (B,)
  ``intersect_expand_csr``     the INTER expand level: the same operands,
                               the survivors front-packed in the kernel
                                          -> (rows (B, out_cap), counts (B,))
  ``intersect_sub_count_csr``  the SUB count leaf: the same, counting A's
                               keys NOT in B; counts in ``intersect_mark``
  ``intersect_count_worklist`` a carried INTER or SUB count leaf read in
                               place from its parent's compacted worklist
                               (no TPU kernel) -> adds to an int64 total
  ``intersect_mark_csr``       SUB expand levels and the per-reference masks:
                               a padded base, B from the CSR, either
                               polarity, the window inside -> bool (B, cap_a)
  ``intersect_multi_csr``      the general count leaf: k references (and a
                               fresh base) as vertex ids       -> counts (B,)
  ``intersect_multi_mark_csr`` general expand levels: a padded base, the k
                               references from the CSR      -> bool (B, cap_a)
  ``intersect_multi_count_worklist`` a general count leaf read in place
                               from its parent's compacted worklist, its
                               vertices the parent's new vertex and the
                               columns it forwards (no TPU kernel) -> adds to
                               an int64 total; launches in ``intersect_multi``
  ``intersect_multi_agg_csr``  the aggregate leaf: the k references (and a
                               fresh base) as vertex ids, their values from
                               the CSR's value plane; no mark -> (counts, vals)

Contract of the first three: ``a`` (B, cap_a) and ``b`` (B, cap_b) are
int32 rows, each a sorted set padded with SENTINEL, caps multiples of 128.
Slot s of row i counts iff ``a[i,s] != SENTINEL``,
``lbounds[i] < a[i,s] < bounds[i]`` and ``a[i,s]`` is in ``b[i]``.
``bounds=None`` means SENTINEL, ``lbounds=None`` means -1; bound 0 kills a
row. ``intersect_multi`` takes a (k, B, cap_b) stack of references with an
INTER-first polarity instead of ``b`` (see its docstring);
``intersect_multi_agg`` adds the SVPU value lane to it.

Each wrapper picks its path by the device of its tensors: a CPU tensor
takes the plain version beside it (``*_ref``, ``torch.searchsorted``
based); a CUDA tensor launches the kernel on the current stream, or raises.
``launches`` on each wrapper counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import (AGG_OPS, batch_compact_rows, batch_compact_scan,
                                    batch_sub_count, inter_keep, level_agg, level_keep)
from repro_torch.core.stream import LANE, SENTINEL
from repro_torch.graph.csr import csr_rows

from .build import launch

MAX_REFS = 8     # kMaxRefs of csrc/intersect.cu: references per k-ref level
MAX_COLS = 8     # kMaxCols of csrc/rows.cuh: columns of a worklist's items
AGG_IDS = {op: i for i, op in enumerate(AGG_OPS)}   # op operand of the agg kernel


def intersect_count_ref(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_count``."""
    return inter_keep(a, b, bounds, lbounds).sum(dim=1, dtype=torch.int32)


def intersect_expand_ref(a, b, bounds=None, lbounds=None):
    """Plain torch version of ``intersect_expand``: (mark int32, counts)."""
    keep = inter_keep(a, b, bounds, lbounds)
    return keep.to(torch.int32), keep.sum(dim=1, dtype=torch.int32)


def intersect_mark_ref(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_mark``: mark int32."""
    return inter_keep(a, b, bounds, lbounds).to(torch.int32)


def intersect_multi_ref(a, bs, pol, bounds=None, lbounds=None, excludes=None):
    """Plain torch version of ``intersect_multi``: (mark int32, counts)."""
    keep = level_keep(a, bs, pol, bounds, lbounds, excludes)
    return keep.to(torch.int32), keep.sum(dim=1, dtype=torch.int32)


def intersect_multi_agg_ref(a, bs, pol, a_vals, b_vals, scale, op="sum",
                            bounds=None, lbounds=None, excludes=None):
    """Plain torch version of ``intersect_multi_agg``: (mark int32, counts,
    vals f32)."""
    keep, vals = level_agg(a, bs, pol, a_vals, b_vals, scale, op, bounds,
                           lbounds, excludes)
    return keep.to(torch.int32), keep.sum(dim=1, dtype=torch.int32), vals


def intersect_count_csr_ref(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                            bounds=None, lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_count_csr``: the rows gathered as
    ``graph.csr.padded_rows`` gathers them, then ``intersect_count_ref``."""
    if a is None:
        a = csr_rows(indptr, indices, va, cap_a)
    return intersect_count_ref(a, csr_rows(indptr, indices, vb, cap_b), bounds, lbounds)


def intersect_expand_csr_ref(indptr, indices, vb, cap_b, out_cap: int, a=None, va=None,
                             cap_a=None, bounds=None, lbounds=None):
    """Plain torch version of ``intersect_expand_csr``: the rows gathered,
    ``intersect_expand_ref``'s mark, then ``batch_compact_rows``."""
    if a is None:
        a = csr_rows(indptr, indices, va, cap_a)
    mark, counts = intersect_expand_ref(a, csr_rows(indptr, indices, vb, cap_b), bounds,
                                        lbounds)
    return batch_compact_rows(a, mark > 0, out_cap)[0], counts


def expand_items_ref(rows, counts, offs, out_items: int):
    """Plain torch version of ``expand_items``: ``batch_compact_scan``'s
    (src, verts) over the front-packed rows (``offs`` is the exclusive
    prefix sum of ``counts``, which the scan computes itself)."""
    keep = torch.arange(rows.shape[1], device=rows.device)[None] < counts[:, None]
    return batch_compact_scan(rows, keep, rows.shape[1], out_items)[2:4]


def _csr_stack(indptr, indices, vbs, caps_b, values=None) -> torch.Tensor:
    """The (k, B, max cap) stack of the references' CSR rows, each gathered
    at its cap and SENTINEL-padded to the widest (0.0-padded values, given
    ``values``): the padded forms' ``bs`` (or ``b_vals``) operand."""
    capmax = max(caps_b)
    fill = SENTINEL if values is None else 0.0
    return torch.stack([torch.nn.functional.pad(csr_rows(indptr, indices, vbs[r], c, values),
                                                (0, capmax - c), value=fill)
                        for r, c in enumerate(caps_b)])


def intersect_multi_agg_csr_ref(indptr, indices, edge_values, vbs, caps_b, pol, scale,
                                op="sum", a=None, va=None, cap_a=None, a_vals=None,
                                bounds=None, lbounds=None, excludes=None):
    """Plain torch version of ``intersect_multi_agg_csr``: each reference's
    keys and values gathered at its cap and SENTINEL / 0.0-padded to the
    widest, A's likewise (or 1.0 for a padded ``a`` without ``a_vals``),
    then ``intersect_multi_agg_ref`` without its mark -> (counts, vals)."""
    bs = _csr_stack(indptr, indices, vbs, caps_b)
    bv = _csr_stack(indptr, indices, vbs, caps_b, edge_values)
    if a is None:
        a = csr_rows(indptr, indices, va, cap_a)
        a_vals = csr_rows(indptr, indices, va, cap_a, edge_values)
    elif a_vals is None:
        a_vals = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    _, counts, vals = intersect_multi_agg_ref(a, bs, pol, a_vals, bv, scale, op, bounds,
                                              lbounds, excludes)
    return counts, vals


def intersect_sub_count_csr_ref(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                                bounds=None, lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_sub_count_csr``: the rows gathered
    as ``graph.csr.padded_rows`` gathers them, then the SUB count."""
    if a is None:
        a = csr_rows(indptr, indices, va, cap_a)
    return batch_sub_count(a, csr_rows(indptr, indices, vb, cap_b), bounds, lbounds)


def intersect_mark_csr_ref(indptr, indices, a, vb, cap_b, sub=False, bounds=None,
                           lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_mark_csr``: B's rows gathered,
    then the keep mask of ``intersect_multi_ref`` with one reference."""
    b = csr_rows(indptr, indices, vb, cap_b)
    return level_keep(a, b[None], (0,) if sub else (1,), bounds, lbounds)


def intersect_multi_csr_ref(indptr, indices, vbs, caps_b, pol, a=None, va=None,
                            cap_a=None, bounds=None, lbounds=None,
                            excludes=None) -> torch.Tensor:
    """Plain torch version of ``intersect_multi_csr``: the references (and a
    fresh base) gathered, then ``intersect_multi_ref``'s counts."""
    if a is None:
        a = csr_rows(indptr, indices, va, cap_a)
    return intersect_multi_ref(a, _csr_stack(indptr, indices, vbs, caps_b), pol, bounds,
                               lbounds, excludes)[1]


def intersect_multi_mark_csr_ref(indptr, indices, a, vbs, caps_b, pol, bounds=None,
                                 lbounds=None, excludes=None) -> torch.Tensor:
    """Plain torch version of ``intersect_multi_mark_csr``: the references
    gathered, then ``intersect_multi_ref``'s mark as bool."""
    return level_keep(a, _csr_stack(indptr, indices, vbs, caps_b), pol, bounds, lbounds,
                      excludes)


def intersect_multi_count_worklist_ref(indptr, indices, rows2, src, verts2, cols, lo: int,
                                       m: int, total, base, cap_a: int, refs, caps_b, pol,
                                       ub=(), lb=(), exclude=()):
    """Plain torch version of ``intersect_multi_count_worklist``: the
    chunk's columns gathered through ``src`` (the new vertex sliced), then
    the general CSR count leaf's plain version, its sum added to ``total``."""
    s = src[lo: lo + m].long()

    def col(c):
        return verts2[lo: lo + m] if c == len(cols) else cols[c][s]
    base_kw = dict(a=rows2[s, :cap_a]) if base is None else dict(va=col(base), cap_a=cap_a)
    bounds = lbounds = excludes = None
    if ub:
        bounds = torch.stack([col(c) for c in ub]).amin(dim=0)
    if lb:
        lbounds = torch.stack([col(c) for c in lb]).amax(dim=0)
    if exclude:
        excludes = torch.stack([col(c) for c in exclude], dim=1)
    counts = intersect_multi_csr_ref(indptr, indices, torch.stack([col(c) for c in refs]),
                                     caps_b, pol, **base_kw, bounds=bounds, lbounds=lbounds,
                                     excludes=excludes)
    total += counts.sum(dtype=torch.int64)
    return total


def intersect_multi_count_worklist(indptr, indices, rows2, src, verts2, cols, lo: int,
                                   m: int, total, base, cap_a: int, refs, caps_b, pol,
                                   ub=(), lb=(), exclude=()):
    """A general count leaf read in place from its parent expand's
    compacted worklist: adds the chunk's count to ``total`` and returns it.

    ``src`` and ``verts2`` (items,) are the parent's worklist and ``cols``
    the (B,) int32 columns its wave forwards, by column number (None for a
    column the leaf does not read); column ``len(cols)`` is the parent's
    new vertex. Item i of the chunk [lo, lo + m) reads column c at
    ``cols[c][src[lo + i]]``, the new vertex at ``verts2[lo + i]``. Its base
    is the neighbour list of column ``base``'s vertex cut at ``cap_a``, or,
    with ``base`` None, the parent's carried survivors
    ``rows2[src[lo + i], :cap_a]`` (``rows2`` (B, out_cap)). Its references
    are the neighbour lists of columns ``refs`` cut at ``caps_b``, with an
    INTER-first polarity ``pol``; its upper bound the least vertex of the
    ``ub`` columns (none: SENTINEL), its lower bound the greatest of the
    ``lb`` columns (none: -1), its excludes the vertices of the ``exclude``
    columns. The count equals ``intersect_multi_csr`` on the sliced chunk,
    summed. ``total`` is a 0-d int64 tensor; on the card the kernel adds to
    it in place, one launch and no other kernel. ``src`` must index the
    columns' rows (and ``rows2``'s) and the ids be vertices of the CSR:
    checking them would cost a read of the device. Launches count in
    ``intersect_multi.launches``."""
    _check_csr(indptr, indices)
    dev = indptr.device
    items = _check_vertices("src", src, dev)
    _check_tensor("verts2", verts2, (items,), torch.int32, dev)
    _check_tensor("total", total, (), torch.int64, dev)
    vcol = len(cols)
    refs, caps_b, pol = tuple(refs), tuple(caps_b), tuple(pol)
    k, n_inter = len(refs), sum(pol)
    if not 1 <= k == len(caps_b) == len(pol) <= MAX_REFS or len(set(refs)) != k:
        raise ValueError(f"refs {refs}, caps_b {caps_b}, pol {pol}: need 1 <= k distinct "
                         f"columns == len(caps_b) == len(pol) <= {MAX_REFS}")
    if set(pol) - {0, 1} or pol != (1,) * n_inter + (0,) * (k - n_inter):
        raise ValueError(f"pol {pol} must be 1s (INTER) then 0s (SUB)")
    for c in (*caps_b, cap_a):
        _check_cap("cap", c)
    used = {*refs, *ub, *lb, *exclude} | ({base} if base is not None else set())
    if vcol >= MAX_COLS or not all(isinstance(c, int) and 0 <= c <= vcol for c in used):
        raise ValueError(f"columns {sorted(used, key=str)} must lie in [0, {vcol}] "
                         f"< {MAX_COLS}")
    for c in used - {vcol}:
        if cols[c] is None or cols[c].dim() != 1:
            raise ValueError(f"column {c} must be a (B,) tensor, got {cols[c]!r}")
        _check_tensor(f"column {c}", cols[c], tuple(cols[c].shape), torch.int32, dev)
    if base is None:
        if rows2 is None or rows2.dim() != 2:
            raise ValueError("a carried base needs rows2 (B, out_cap)")
        _check_tensor("rows2", rows2, tuple(rows2.shape), torch.int32, dev)
        if cap_a > rows2.shape[1]:
            raise ValueError(f"cap_a {cap_a} > rows2's width {rows2.shape[1]}")
    if not (isinstance(lo, int) and isinstance(m, int) and 0 <= lo <= lo + m <= items):
        raise ValueError(f"chunk [{lo}, {lo} + {m}) is not inside the {items} items")
    if dev.type == "cpu":
        return intersect_multi_count_worklist_ref(indptr, indices, rows2, src, verts2, cols,
                                                  lo, m, total, base, cap_a, refs, caps_b,
                                                  pol, ub, lb, exclude)
    if dev.type != "cuda":
        raise ValueError(f"no intersect kernel for device {dev}")
    if m:
        caps = [1] * MAX_COLS
        for c, cap in zip(refs, caps_b):
            caps[c] = cap

        def mask(cs):
            return sum(1 << c for c in set(cs))
        carried = base is None
        launch("intersect", "repro_intersect_multi_count_worklist", dev,
               (indptr, indices, rows2 if carried else None, src, verts2,
                *(cols[c] if c in used and c != vcol else None for c in range(MAX_COLS)),
                total),
               (lo, m, rows2.shape[1] if carried else 0, cap_a, -1 if carried else base,
                vcol, mask(refs[:n_inter]), mask(refs[n_inter:]), mask(ub), mask(lb),
                mask(exclude), *caps))
        intersect_multi.launches += 1
    return total


def _check_rows(name: str, t: torch.Tensor, a: torch.Tensor, ndim: int = 2) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.shape[-1] % LANE:
        raise ValueError(f"{name} capacity {t.shape[-1]} is not a multiple "
                         f"of {LANE}")
    if t.device != a.device:
        raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if t.shape[-2] != a.shape[0]:
        raise ValueError(f"a has {a.shape[0]} rows, {name} {t.shape[-2]}")


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape and type on
    ``device`` (attribute reads only, no tensor ops)."""
    if t.dtype != dtype or t.shape != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_bounds(a: torch.Tensor, bounds, lbounds, rows: int | None = None) -> None:
    """bounds / lbounds: None or (rows,) int32 on ``a``'s device (rows
    defaults to a's: ``a`` is the base rows, or the CSR's indptr)."""
    rows = a.shape[0] if rows is None else rows
    for name, t in (("bounds", bounds), ("lbounds", lbounds)):
        if t is not None:
            _check_tensor(name, t, (rows,), torch.int32, a.device)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no intersect kernel for device {a.device}")


def _check_cap(name: str, cap) -> None:
    if not isinstance(cap, int) or not 0 < cap < SENTINEL:
        raise ValueError(f"{name} must be a positive int, got {cap!r}")


def _check_csr(indptr, indices, values=None) -> None:
    """The CSR operand: 1-D int32 indptr and indices (and f32 values aligned
    with indices) on one device."""
    if indptr.dim() != 1:
        raise ValueError(f"indptr must be 1-D, got {tuple(indptr.shape)}")
    _check_tensor("indptr", indptr, tuple(indptr.shape), torch.int32, indptr.device)
    if indices.dim() != 1:
        raise ValueError(f"indices must be 1-D, got {tuple(indices.shape)}")
    _check_tensor("indices", indices, tuple(indices.shape), torch.int32, indptr.device)
    if values is not None:
        _check_tensor("edge_values", values, tuple(indices.shape), torch.float32,
                      indptr.device)


def _check_base(indptr, a, va, cap_a, rows: int) -> int:
    """A is a padded (rows, cap_a) matrix ``a`` or CSR rows of ids ``va`` at
    ``cap_a``: exactly one. Returns cap_a."""
    if (a is None) == (va is None):
        raise ValueError("give the base as exactly one of a (padded rows) and "
                         "va (vertex ids)")
    if a is not None:
        _check_rows("a", a, a)
        if a.shape[0] != rows or a.device != indptr.device:
            raise ValueError(f"a must hold {rows} rows on {indptr.device}, got "
                             f"{tuple(a.shape)} on {a.device}")
        if cap_a is not None and cap_a != a.shape[1]:
            raise ValueError(f"cap_a {cap_a} != a's capacity {a.shape[1]}")
        return a.shape[1]
    _check_tensor("va", va, (rows,), torch.int32, indptr.device)
    _check_cap("cap_a", cap_a)
    return cap_a


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """A mark kernel reads ``t``'s rows in 16-byte words."""
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_vertices(name: str, v: torch.Tensor, dev) -> int:
    """(B,) int32 vertex ids on ``dev``; returns B."""
    if v.dim() != 1:
        raise ValueError(f"{name} must be (B,), got {tuple(v.shape)}")
    _check_tensor(name, v, tuple(v.shape), torch.int32, dev)
    return v.shape[0]


def _check_refs(vbs, caps_b, pol, dev) -> tuple[int, int, tuple, tuple, int]:
    """The k CSR references: (k, B) int32 ids ``vbs``, a positive cap each,
    an INTER-first polarity. Returns (k, B, pol, caps_b, n_inter)."""
    pol = tuple(pol)
    caps_b = tuple(caps_b)
    if vbs.dim() != 2:
        raise ValueError(f"vbs must be (k, B), got {tuple(vbs.shape)}")
    k, rows = vbs.shape
    _check_tensor("vbs", vbs, (k, rows), torch.int32, dev)
    if not 1 <= k == len(pol) == len(caps_b) <= MAX_REFS:
        raise ValueError(f"vbs holds {k} refs, pol {pol}, caps_b {caps_b}: need "
                         f"1 <= k == len(pol) == len(caps_b) <= {MAX_REFS}")
    for c in caps_b:
        _check_cap("caps_b", c)
    n_inter = sum(pol)
    if set(pol) - {0, 1} or pol != (1,) * n_inter + (0,) * (k - n_inter):
        raise ValueError(f"pol {pol} must be 1s (INTER) then 0s (SUB)")
    return k, rows, pol, caps_b, n_inter


def _check_excludes(excludes, rows: int, dev) -> int:
    """None or (rows, E) int32 on ``dev``; returns E."""
    if excludes is None:
        return 0
    if excludes.dim() != 2:
        raise ValueError(f"excludes must be (B, E), got {tuple(excludes.shape)}")
    _check_tensor("excludes", excludes, (rows, excludes.shape[1]), torch.int32, dev)
    return excludes.shape[1]


def _check_marked_base(indptr, a, rows: int) -> None:
    """The padded (rows, cap_a) base of a CSR mark form, on the CSR's device."""
    _check_base(indptr, a, None, None, rows)
    _check_aligned("a", a)


def _check(a: torch.Tensor, b: torch.Tensor, bounds, lbounds) -> None:
    """Raise on anything the two-operand kernels do not take."""
    _check_rows("a", a, a)
    _check_rows("b", b, a)
    _check_bounds(a, bounds, lbounds)


def _check_multi(a: torch.Tensor, bs: torch.Tensor, pol, bounds, lbounds,
                 excludes) -> None:
    """Raise on anything the k-reference kernel does not take."""
    _check_rows("a", a, a)
    _check_rows("bs", bs, a, ndim=3)
    pol = tuple(pol)
    if not 1 <= len(pol) == bs.shape[0] <= MAX_REFS:
        raise ValueError(f"bs holds {bs.shape[0]} refs, pol {pol}: need "
                         f"1 <= k == len(pol) <= {MAX_REFS}")
    n_inter = sum(pol)
    if set(pol) - {0, 1} or pol != (1,) * n_inter + (0,) * (len(pol) - n_inter):
        raise ValueError(f"pol {pol} must be 1s (INTER) then 0s (SUB)")
    if excludes is not None and (
            excludes.dtype != torch.int32 or excludes.dim() != 2
            or excludes.shape[0] != a.shape[0] or not excludes.is_contiguous()
            or excludes.device != a.device):
        raise ValueError(f"excludes must be a contiguous ({a.shape[0]}, E) int32 "
                         f"tensor on {a.device}, got {excludes.dtype} "
                         f"{tuple(excludes.shape)} on {excludes.device}")
    _check_bounds(a, bounds, lbounds)


def _check_multi_agg(a, bs, pol, a_vals, b_vals, scale, op, bounds, lbounds,
                     excludes) -> None:
    """Raise on anything the value-lane kernel does not take."""
    _check_multi(a, bs, pol, bounds, lbounds, excludes)
    if op not in AGG_IDS:
        raise ValueError(f"unknown SVPU aggregate {op!r}; use one of {AGG_OPS}")
    for name, t, shape in (("a_vals", a_vals, a.shape), ("b_vals", b_vals, bs.shape),
                           ("scale", scale, a.shape[:1])):
        if t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous() \
                or t.device != a.device:
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} float32 "
                             f"tensor on {a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def intersect_count(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """counts[i] = |{k ∈ A_i ∩ B_i : lbounds[i] < k < bounds[i]}|."""
    _check(a, b, bounds, lbounds)
    if a.device.type == "cpu":
        return intersect_count_ref(a, b, bounds, lbounds)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        launch("intersect", "repro_intersect_count", a.device,
               (a, b, bounds, lbounds, counts), (*a.shape, b.shape[1]))
        intersect_count.launches += 1
    return counts


intersect_count.launches = 0


def intersect_count_csr(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                        bounds=None, lbounds=None) -> torch.Tensor:
    """``intersect_count`` with rows read from a CSR (the count leaf).

    B's row i is the neighbour list of ``vb[i]`` cut at ``cap_b``:
    ``indices[indptr[v] : indptr[v] + min(deg(v), cap_b)]``, the keys
    ``graph.csr.padded_rows`` gathers. A's row i is ``a[i]`` of a padded
    (B, cap_a) matrix (a carried base) or, given ``va`` and ``cap_a``
    instead, the neighbour list of ``va[i]`` cut at ``cap_a``. ``indptr``,
    ``indices``, ``vb``, ``va`` int32; bounds as ``intersect_count``. Ids
    must be vertices of the CSR (0 <= v < len(indptr) - 1): checking them
    would cost a read of the device. Launches count in
    ``intersect_count.launches``."""
    return _count_csr(intersect_count, "repro_intersect_count_csr", intersect_count_csr_ref,
                      indptr, indices, vb, cap_b, a, va, cap_a, bounds, lbounds)


def _count_csr(counter, symbol: str, ref, indptr, indices, vb, cap_b, a, va, cap_a,
               bounds, lbounds) -> torch.Tensor:
    """The count leaves' CSR forms: check, then ``ref`` on the CPU or one
    launch of ``symbol`` counted on ``counter``."""
    _check_csr(indptr, indices)
    rows = _check_vertices("vb", vb, indptr.device)
    _check_cap("cap_b", cap_b)
    cap_a = _check_base(indptr, a, va, cap_a, rows)
    _check_bounds(indptr, bounds, lbounds, rows)
    if indptr.device.type == "cpu":
        return ref(indptr, indices, vb, cap_b, a, va, cap_a, bounds, lbounds)
    counts = torch.empty(rows, dtype=torch.int32, device=indptr.device)
    if rows:
        launch("intersect", symbol, indptr.device,
               (indptr, indices, a, va, vb, bounds, lbounds, counts), (rows, cap_a, cap_b))
        counter.launches += 1
    return counts


def intersect_sub_count_csr(indptr, indices, vb, cap_b, a=None, va=None, cap_a=None,
                            bounds=None, lbounds=None) -> torch.Tensor:
    """The SUB count leaf (S_SUB.C): counts[i] = |{k ∈ A_i \\ B_i :
    lbounds[i] < k < bounds[i]}|, rows as ``intersect_count_csr``'s. It
    runs on the count kernel's template and replaces the mark launch of
    the padded path, so launches count in ``intersect_mark.launches``."""
    return _count_csr(intersect_mark, "repro_intersect_sub_count_csr",
                      intersect_sub_count_csr_ref, indptr, indices, vb, cap_b, a, va,
                      cap_a, bounds, lbounds)


def intersect_count_worklist_ref(indptr, indices, rows2, src, verts2, lo: int, m: int,
                                 cap_a: int, cap_b: int, total, sub: bool = False):
    """Plain torch version of ``intersect_count_worklist``: the chunk's base
    rows gathered through ``src`` and its vertex column sliced, then the
    CSR count leaf's plain version, its sum added to ``total``."""
    v = verts2[lo: lo + m]
    a = rows2[src[lo: lo + m].long(), :cap_a]
    ref = intersect_sub_count_csr_ref if sub else intersect_count_csr_ref
    total += ref(indptr, indices, v, cap_b, a=a, bounds=v).sum(dtype=torch.int64)
    return total


def intersect_count_worklist(indptr, indices, rows2, src, verts2, lo: int, m: int,
                             cap_a: int, cap_b: int, total, sub: bool = False):
    """A carried count leaf read in place from its parent expand's
    compacted worklist: adds the chunk's count to ``total`` and returns it.

    ``rows2`` (B, out_cap), ``src`` and ``verts2`` (items,) are
    ``xinter_compact_csr``'s packed survivor rows and worklist. Item i of
    the chunk [lo, lo + m) has base row ``rows2[src[lo + i], :cap_a]``,
    B's row the neighbour list of ``verts2[lo + i]`` cut at ``cap_b`` and
    upper bound ``verts2[lo + i]``; no lower bound. ``sub`` counts the
    base's keys NOT in B's row (the SUB leaf). The count equals
    ``intersect_count_csr`` (``intersect_sub_count_csr``) on the sliced
    chunk, summed. ``total`` is a 0-d int64 tensor; on the card the kernel
    adds to it in place, one launch and no other kernel. ``src`` must index
    rows of ``rows2`` and ``verts2`` hold vertices of the CSR: checking them
    would cost a read of the device. Launches count in
    ``intersect_count_worklist.launches``."""
    _check_csr(indptr, indices)
    dev = indptr.device
    if rows2.dim() != 2:
        raise ValueError(f"rows2 must be (B, out_cap), got {tuple(rows2.shape)}")
    _check_tensor("rows2", rows2, tuple(rows2.shape), torch.int32, dev)
    items = _check_vertices("src", src, dev)
    _check_tensor("verts2", verts2, (items,), torch.int32, dev)
    _check_tensor("total", total, (), torch.int64, dev)
    _check_cap("cap_a", cap_a)
    _check_cap("cap_b", cap_b)
    if cap_a > rows2.shape[1]:
        raise ValueError(f"cap_a {cap_a} > rows2's width {rows2.shape[1]}")
    if not (isinstance(lo, int) and isinstance(m, int) and 0 <= lo <= lo + m <= items):
        raise ValueError(f"chunk [{lo}, {lo} + {m}) is not inside the {items} items")
    if dev.type == "cpu":
        return intersect_count_worklist_ref(indptr, indices, rows2, src, verts2, lo, m,
                                            cap_a, cap_b, total, sub)
    if dev.type != "cuda":
        raise ValueError(f"no intersect kernel for device {dev}")
    if m:
        launch("intersect", "repro_intersect_sub_count_worklist" if sub
               else "repro_intersect_count_worklist", dev,
               (indptr, indices, rows2, src, verts2, total),
               (lo, m, rows2.shape[1], cap_a, cap_b))
        intersect_count_worklist.launches += 1
    return total


intersect_count_worklist.launches = 0


def intersect_expand(a, b, bounds=None, lbounds=None):
    """Fused bounded membership mark + per-row count in one pass:
    (mark (B, cap_a) int32, counts (B,) int32). The port of the TPU
    kernel's contract; the engine's INTER expand level takes
    ``intersect_expand_csr``, which writes no mark."""
    _check(a, b, bounds, lbounds)
    _check_aligned("a", a)
    if a.device.type == "cpu":
        return intersect_expand_ref(a, b, bounds, lbounds)
    mark = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        launch("intersect", "repro_intersect_expand", a.device,
               (a, b, bounds, lbounds, mark, counts), (*a.shape, b.shape[1]))
        intersect_expand.launches += 1
    return mark, counts


intersect_expand.launches = 0


def intersect_expand_csr(indptr, indices, vb, cap_b, out_cap: int, a=None, va=None,
                         cap_a=None, bounds=None, lbounds=None):
    """The INTER expand level with rows read from a CSR and its survivors
    packed in the kernel -> (rows (B, out_cap) int32, counts (B,) int32).

    B's row i is the neighbour list of ``vb[i]`` cut at ``cap_b``; A's row i
    is ``a[i]`` of a padded (B, cap_a) matrix (a carried base) or, given
    ``va`` and ``cap_a``, the neighbour list of ``va[i]`` cut at ``cap_a``
    (a fresh base), as in ``intersect_count_csr``. ``rows[i]`` holds A_i's
    keys inside (lbounds[i], bounds[i]) that are in B_i, in order,
    front-packed, SENTINEL after; ``counts[i]`` their number. Bound 0 kills
    a row. ``out_cap`` must be at least min(cap_a, cap_b), so that no row is
    cut: the rows then equal ``batch_compact_rows(a, intersect_expand(a, b,
    ...)[0] > 0, out_cap)`` and feed ``expand_items``. No (B, cap_a) mark is
    written. Launches count in ``intersect_expand.launches``."""
    _check_csr(indptr, indices)
    rows = _check_vertices("vb", vb, indptr.device)
    _check_cap("cap_b", cap_b)
    cap_a = _check_base(indptr, a, va, cap_a, rows)
    _check_bounds(indptr, bounds, lbounds, rows)
    _check_cap("out_cap", out_cap)
    if out_cap < min(cap_a, cap_b):
        raise ValueError(f"out_cap {out_cap} < min(cap_a, cap_b) = {min(cap_a, cap_b)}: "
                         "a row could be cut, and its worklist with it")
    if indptr.device.type == "cpu":
        return intersect_expand_csr_ref(indptr, indices, vb, cap_b, out_cap, a, va, cap_a,
                                        bounds, lbounds)
    out = torch.empty((rows, out_cap), dtype=torch.int32, device=indptr.device)
    counts = torch.empty(rows, dtype=torch.int32, device=indptr.device)
    if rows:
        launch("intersect", "repro_intersect_expand_csr", indptr.device,
               (indptr, indices, a, va, vb, bounds, lbounds, out, counts),
               (rows, cap_a, cap_b, out_cap))
        intersect_expand.launches += 1
    return out, counts


def expand_items(rows, counts, offs, out_items: int):
    """The worklist of an expand level's survivors -> (src, verts), each
    (out_items,) int32.

    ``rows`` (B, out_cap) holds each row's survivors front-packed
    (``intersect_expand_csr``'s), ``counts`` (B,) their numbers, none above
    out_cap, and ``offs`` (B,) the exclusive prefix sum of ``counts``. Item
    offs[i] + j is (i, rows[i, j]) for j < counts[i]; items from the total
    on are (0, 0), and items past ``out_items`` drop: ``batch_compact_scan``'s
    src and verts on the same survivors. One launch of a kernel of
    ``csrc/intersect.cu``, counted in ``expand_items.launches``."""
    dev = rows.device
    if rows.dim() != 2:
        raise ValueError(f"rows must be (B, out_cap), got {tuple(rows.shape)}")
    _check_tensor("rows", rows, tuple(rows.shape), torch.int32, dev)
    batch, out_cap = rows.shape
    _check_tensor("counts", counts, (batch,), torch.int32, dev)
    _check_tensor("offs", offs, (batch,), torch.int32, dev)
    _check_cap("out_cap", out_cap)
    _check_cap("out_items", out_items)
    if dev.type == "cpu":
        return expand_items_ref(rows, counts, offs, out_items)
    if dev.type != "cuda":
        raise ValueError(f"no expand-items kernel for device {dev}")
    src = torch.empty(out_items, dtype=torch.int32, device=dev)
    verts = torch.empty(out_items, dtype=torch.int32, device=dev)
    launch("intersect", "repro_expand_items", dev, (rows, counts, offs, src, verts),
           (batch, out_cap, out_items))
    expand_items.launches += 1
    return src, verts


expand_items.launches = 0


def intersect_mark(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """Bounded membership mark: mark[i, s] = 1 iff A_i[s] ∈ B_i and
    lbounds[i] < A_i[s] < bounds[i], else 0 — (B, cap_a) int32."""
    _check(a, b, bounds, lbounds)
    _check_aligned("a", a)
    if a.device.type == "cpu":
        return intersect_mark_ref(a, b, bounds, lbounds)
    mark = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if a.shape[0]:
        launch("intersect", "repro_intersect_mark", a.device,
               (a, b, bounds, lbounds, mark), (*a.shape, b.shape[1]))
        intersect_mark.launches += 1
    return mark


intersect_mark.launches = 0


def intersect_mark_csr(indptr, indices, a, vb, cap_b, sub=False, bounds=None,
                       lbounds=None) -> torch.Tensor:
    """The keep row of one reference read from the CSR, over a padded base:
    mark[i, s] = A_i[s] live, lbounds[i] < A_i[s] < bounds[i] and
    (A_i[s] ∈ B_i) != sub -> (B, cap_a) bool.

    ``a`` is (B, cap_a) padded rows (an expand level's base); B's row i is
    the neighbour list of ``vb[i]`` cut at ``cap_b``, as in
    ``intersect_count_csr``. ``sub=True`` is a SUB level's keep mask, its
    window applied in the kernel; ``sub=False`` without bounds is the
    membership mark a ``fused_level=False`` level ANDs per reference.
    Launches count in ``intersect_mark.launches``."""
    _check_csr(indptr, indices)
    rows = _check_vertices("vb", vb, indptr.device)
    _check_cap("cap_b", cap_b)
    _check_marked_base(indptr, a, rows)
    _check_bounds(indptr, bounds, lbounds, rows)
    if indptr.device.type == "cpu":
        return intersect_mark_csr_ref(indptr, indices, a, vb, cap_b, sub, bounds, lbounds)
    mark = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    if rows:
        launch("intersect", "repro_intersect_mark_csr", a.device,
               (indptr, indices, a, vb, bounds, lbounds, mark),
               (rows, a.shape[1], cap_b, int(bool(sub))))
        intersect_mark.launches += 1
    return mark


def intersect_multi(a, bs, pol, bounds=None, lbounds=None, excludes=None):
    """Fused k-reference level: conjunctive mark + count in one pass.

    mark[i, s] = 1 iff  A_i[s] ∈ B^r_i  for every INTER ref r (pol[r] = 1)
               and      A_i[s] ∉ B^r_i  for every SUB ref r   (pol[r] = 0)
               and      lbounds[i] < A_i[s] < bounds[i]
               and      A_i[s] != excludes[i, e] for every e  (-1: no-op);
    counts[i] = Σ_s mark[i, s].

    ``bs`` is the (k, B, cap_b) reference stack, each ref SENTINEL-padded to
    the common cap_b; ``pol`` is INTER-first (1s, then 0s); ``excludes`` is
    (B, E) int32 or None. Returns (mark (B, cap_a) int32, counts (B,) int32).
    """
    _check_multi(a, bs, pol, bounds, lbounds, excludes)
    _check_aligned("a", a)
    if a.device.type == "cpu":
        return intersect_multi_ref(a, bs, pol, bounds, lbounds, excludes)
    mark = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        n_excl = 0 if excludes is None else excludes.shape[1]
        launch("intersect", "repro_intersect_multi", a.device,
               (a, bs, bounds, lbounds, excludes if n_excl else None, mark, counts),
               (*a.shape, bs.shape[2], len(pol), sum(pol), n_excl))
        intersect_multi.launches += 1
    return mark, counts


intersect_multi.launches = 0


def intersect_multi_csr(indptr, indices, vbs, caps_b, pol, a=None, va=None, cap_a=None,
                        bounds=None, lbounds=None, excludes=None) -> torch.Tensor:
    """The general count leaf: ``intersect_multi``'s counts with the
    references read from a CSR and no mark written -> counts (B,) int32.

    Reference r of row i is the neighbour list of ``vbs[r, i]`` cut at
    ``caps_b[r]`` ((k, B) int32 ids, k = len(pol) = len(caps_b)); the base
    is a padded (B, cap_a) ``a`` (a carried or gathered base) or the
    neighbour list of ``va[i]`` cut at ``cap_a`` (a fresh base). Polarity,
    bounds and excludes as ``intersect_multi``; ids as in
    ``intersect_count_csr``. Launches count in ``intersect_multi.launches``."""
    _check_csr(indptr, indices)
    dev = indptr.device
    k, rows, pol, caps_b, n_inter = _check_refs(vbs, caps_b, pol, dev)
    cap_a = _check_base(indptr, a, va, cap_a, rows)
    n_excl = _check_excludes(excludes, rows, dev)
    _check_bounds(indptr, bounds, lbounds, rows)
    if dev.type == "cpu":
        return intersect_multi_csr_ref(indptr, indices, vbs, caps_b, pol, a, va, cap_a,
                                       bounds, lbounds, excludes)
    counts = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        launch("intersect", "repro_intersect_multi_csr", dev,
               (indptr, indices, a, va, vbs, bounds, lbounds,
                excludes if n_excl else None, None, counts),
               (rows, cap_a, k, n_inter, n_excl, *caps_b, *(1,) * (MAX_REFS - k)))
        intersect_multi.launches += 1
    return counts


def intersect_multi_mark_csr(indptr, indices, a, vbs, caps_b, pol, bounds=None,
                             lbounds=None, excludes=None) -> torch.Tensor:
    """A general expand level's keep row: ``intersect_multi``'s mark over a
    padded (B, cap_a) base ``a``, the references read from a CSR as in
    ``intersect_multi_csr`` -> (B, cap_a) bool (no counts: the compaction
    counts). Launches count in ``intersect_multi.launches``."""
    _check_csr(indptr, indices)
    dev = indptr.device
    k, rows, pol, caps_b, n_inter = _check_refs(vbs, caps_b, pol, dev)
    _check_marked_base(indptr, a, rows)
    n_excl = _check_excludes(excludes, rows, dev)
    _check_bounds(indptr, bounds, lbounds, rows)
    if dev.type == "cpu":
        return intersect_multi_mark_csr_ref(indptr, indices, a, vbs, caps_b, pol, bounds,
                                            lbounds, excludes)
    mark = torch.empty(a.shape, dtype=torch.bool, device=dev)
    if rows:
        launch("intersect", "repro_intersect_multi_csr", dev,
               (indptr, indices, a, None, vbs, bounds, lbounds,
                excludes if n_excl else None, mark, None),
               (rows, a.shape[1], k, n_inter, n_excl, *caps_b, *(1,) * (MAX_REFS - k)))
        intersect_multi.launches += 1
    return mark


def intersect_multi_agg(a, bs, pol, a_vals, b_vals, scale, op="sum", bounds=None,
                        lbounds=None, excludes=None):
    """``intersect_multi`` plus the SVPU value lane -> (mark, counts, vals).

    Each kept slot s of row i carries
    ``a_vals[i, s] · Π_{INTER refs r} matched_val_r(i, s) · scale[i]``,
    multiplied in that order, and ``vals[i]`` reduces the kept slots with
    ``op`` ('sum' / 'max' / 'min'; a row with none gives 0.0 / -3.4e38 /
    +3.4e38). ``a_vals`` is (B, cap_a) f32, ``b_vals`` the (k, B, cap_b) f32
    value stack aligned with ``bs`` (SUB refs' values are not read),
    ``scale`` (B,) f32. Returns (mark (B, cap_a) int32, counts (B,) int32,
    vals (B,) f32).
    """
    _check_multi_agg(a, bs, pol, a_vals, b_vals, scale, op, bounds, lbounds, excludes)
    if a.device.type == "cpu":
        return intersect_multi_agg_ref(a, bs, pol, a_vals, b_vals, scale, op, bounds,
                                       lbounds, excludes)
    mark = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    vals = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    if a.shape[0]:
        n_excl = 0 if excludes is None else excludes.shape[1]
        launch("intersect", "repro_intersect_multi_agg", a.device,
               (a, bs, bounds, lbounds, excludes if n_excl else None, a_vals, b_vals,
                scale, mark, counts, vals),
               (*a.shape, bs.shape[2], len(pol), sum(pol), n_excl, AGG_IDS[op]))
        intersect_multi_agg.launches += 1
    return mark, counts, vals


intersect_multi_agg.launches = 0


def intersect_multi_agg_csr(indptr, indices, edge_values, vbs, caps_b, pol, scale,
                            op="sum", a=None, va=None, cap_a=None, a_vals=None,
                            bounds=None, lbounds=None, excludes=None):
    """The aggregate leaf: ``intersect_multi_agg``'s counts and vals, with
    rows read from a CSR and no mark written -> (counts (B,) int32, vals (B,)
    f32).

    Reference r of row i is the neighbour list of ``vbs[r, i]`` cut at
    ``caps_b[r]`` ((k, B) int32 ids, k = len(pol) = len(caps_b)); a matched
    key at CSR position p carries ``edge_values[p]``. The base is either a
    padded (B, cap_a) ``a`` with ``a_vals`` (B, cap_a) f32 or None (every
    value 1.0: a carried base), or the neighbour list of ``va[i]`` cut at
    ``cap_a``, carrying its own edge values (a fresh base). Membership,
    products, order and identities as ``intersect_multi_agg``; ids as in
    ``intersect_count_csr``. Launches count in
    ``intersect_multi_agg.launches``."""
    _check_csr(indptr, indices, edge_values)
    dev = indptr.device
    k, rows, pol, caps_b, n_inter = _check_refs(vbs, caps_b, pol, dev)
    cap_a = _check_base(indptr, a, va, cap_a, rows)
    if a_vals is not None:
        if a is None:
            raise ValueError("a_vals goes with a padded base a; a CSR base va "
                             "carries its own edge values")
        _check_tensor("a_vals", a_vals, tuple(a.shape), torch.float32, dev)
    if op not in AGG_IDS:
        raise ValueError(f"unknown SVPU aggregate {op!r}; use one of {AGG_OPS}")
    _check_tensor("scale", scale, (rows,), torch.float32, dev)
    n_excl = _check_excludes(excludes, rows, dev)
    _check_bounds(indptr, bounds, lbounds, rows)
    if dev.type == "cpu":
        return intersect_multi_agg_csr_ref(indptr, indices, edge_values, vbs, caps_b,
                                           pol, scale, op, a, va, cap_a, a_vals,
                                           bounds, lbounds, excludes)
    counts = torch.empty(rows, dtype=torch.int32, device=dev)
    vals = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        launch("intersect", "repro_intersect_multi_agg_csr", dev,
               (indptr, indices, edge_values, a, a_vals, va, vbs, bounds, lbounds,
                excludes if n_excl else None, scale, counts, vals),
               (rows, cap_a, k, n_inter, n_excl, AGG_IDS[op],
                *caps_b, *(1,) * (MAX_REFS - k)))
        intersect_multi_agg.launches += 1
    return counts, vals
