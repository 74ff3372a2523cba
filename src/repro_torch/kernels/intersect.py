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

from repro_torch.core.batch import AGG_OPS, inter_keep, level_agg, level_keep
from repro_torch.core.stream import LANE

from .build import launch

MAX_REFS = 8     # kMaxRefs of csrc/intersect.cu: references per k-ref level
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


def _check_bounds(a: torch.Tensor, bounds, lbounds) -> None:
    for name, t in (("bounds", bounds), ("lbounds", lbounds)):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (a.shape[0],) \
                or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name} must be a contiguous ({a.shape[0]},) int32 "
                             f"tensor on {a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no intersect kernel for device {a.device}")


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


def intersect_expand(a, b, bounds=None, lbounds=None):
    """Fused bounded membership mark + per-row count in one pass:
    (mark (B, cap_a) int32, counts (B,) int32)."""
    _check(a, b, bounds, lbounds)
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


def intersect_mark(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """Bounded membership mark: mark[i, s] = 1 iff A_i[s] ∈ B_i and
    lbounds[i] < A_i[s] < bounds[i], else 0 — (B, cap_a) int32."""
    _check(a, b, bounds, lbounds)
    if a.device.type == "cpu":
        return intersect_mark_ref(a, b, bounds, lbounds)
    mark = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if a.shape[0]:
        launch("intersect", "repro_intersect_mark", a.device,
               (a, b, bounds, lbounds, mark), (*a.shape, b.shape[1]))
        intersect_mark.launches += 1
    return mark


intersect_mark.launches = 0


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
