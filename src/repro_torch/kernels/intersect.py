"""Batched bounded sorted-set intersection — the IntersectX IU on Hopper.

Four hand-written CUDA kernels (``csrc/intersect.cu``) replace the Pallas
kernels of ``repro/kernels/intersect.py`` on the mining main path:

  ``intersect_count``   <- ``intersect_count_pallas``  -> counts (B,)
  ``intersect_expand``  <- ``intersect_expand_pallas`` -> (mark (B, cap_a),
                                                           counts (B,))
  ``intersect_mark``    <- ``intersect_mark_pallas``   -> mark (B, cap_a)
  ``intersect_multi``   <- ``intersect_multi_pallas``  -> (mark (B, cap_a),
                                                           counts (B,))

Contract of the first three: ``a`` (B, cap_a) and ``b`` (B, cap_b) are
int32 rows, each a sorted set padded with SENTINEL, caps multiples of 128.
Slot s of row i counts iff ``a[i,s] != SENTINEL``,
``lbounds[i] < a[i,s] < bounds[i]`` and ``a[i,s]`` is in ``b[i]``.
``bounds=None`` means SENTINEL, ``lbounds=None`` means -1; bound 0 kills a
row. ``intersect_multi`` takes a (k, B, cap_b) stack of references with an
INTER-first polarity instead of ``b`` (see its docstring).

Each wrapper picks its path by the device of its tensors: a CPU tensor
takes the plain version beside it (``*_ref``, ``torch.searchsorted``
based); a CUDA tensor launches the kernel on the current stream, or raises.
``launches`` on each wrapper counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batch import inter_keep, level_keep
from repro_torch.core.stream import LANE

from .build import load

MAX_REFS = 8     # kMaxRefs of csrc/intersect.cu: references per k-ref level


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


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(symbol: str, a, tensors, ints) -> None:
    """Launch one kernel of ``csrc/intersect.cu`` on ``a``'s current stream:
    ``symbol(*tensor pointers (None -> NULL), *ints, stream)``."""
    fn = getattr(load("intersect").lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * len(tensors) \
            + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(*(_ptr(t) for t in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def intersect_count(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """counts[i] = |{k ∈ A_i ∩ B_i : lbounds[i] < k < bounds[i]}|."""
    _check(a, b, bounds, lbounds)
    if a.device.type == "cpu":
        return intersect_count_ref(a, b, bounds, lbounds)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        _launch("repro_intersect_count", a, (a, b, bounds, lbounds, counts),
                (*a.shape, b.shape[1]))
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
        _launch("repro_intersect_expand", a,
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
        _launch("repro_intersect_mark", a, (a, b, bounds, lbounds, mark),
                (*a.shape, b.shape[1]))
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
        _launch("repro_intersect_multi", a,
                (a, bs, bounds, lbounds, excludes if n_excl else None, mark,
                 counts),
                (*a.shape, bs.shape[2], len(pol), sum(pol), n_excl))
        intersect_multi.launches += 1
    return mark, counts


intersect_multi.launches = 0
