"""Batched bounded sorted-set intersection — the IntersectX IU on Hopper.

Two hand-written CUDA kernels (``csrc/intersect.cu``) replace the Pallas
kernels of ``repro/kernels/intersect.py`` on the mining main path:

  ``intersect_count``   <- ``intersect_count_pallas``  -> counts (B,)
  ``intersect_expand``  <- ``intersect_expand_pallas`` -> (mark (B, cap_a),
                                                           counts (B,))

Contract: ``a`` (B, cap_a) and ``b`` (B, cap_b) are int32 rows, each a
sorted set padded with SENTINEL, caps multiples of 128. Slot s of row i
counts iff ``a[i,s] != SENTINEL``, ``lbounds[i] < a[i,s] < bounds[i]`` and
``a[i,s]`` is in ``b[i]``. ``bounds=None`` means SENTINEL, ``lbounds=None``
means -1; bound 0 kills a row.

Each wrapper picks its path by the device of its tensors: a CPU tensor
takes the plain version beside it (``intersect_count_ref`` /
``intersect_expand_ref``, ``torch.searchsorted`` based); a CUDA tensor
launches the kernel on the current stream, or raises. ``launches`` on each
wrapper counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batch import inter_keep
from repro_torch.core.stream import LANE

from .build import load


def intersect_count_ref(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """Plain torch version of ``intersect_count``."""
    return inter_keep(a, b, bounds, lbounds).sum(dim=1, dtype=torch.int32)


def intersect_expand_ref(a, b, bounds=None, lbounds=None):
    """Plain torch version of ``intersect_expand``: (mark int32, counts)."""
    keep = inter_keep(a, b, bounds, lbounds)
    return keep.to(torch.int32), keep.sum(dim=1, dtype=torch.int32)


def _check(a: torch.Tensor, b: torch.Tensor, bounds, lbounds) -> None:
    """Raise on anything the kernels do not take."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.shape[1] % LANE:
            raise ValueError(f"{name} capacity {t.shape[1]} is not a multiple "
                             f"of {LANE}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if b.shape[0] != a.shape[0]:
        raise ValueError(f"a has {a.shape[0]} rows, b {b.shape[0]}")
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


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(symbol: str, a, b, bounds, lbounds, *outs) -> None:
    """Launch one kernel of ``csrc/intersect.cu`` on the current stream."""
    fn = getattr(load("intersect").lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (4 + len(outs)) \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(_ptr(a), _ptr(b), _ptr(bounds), _ptr(lbounds),
                *(o.data_ptr() for o in outs),
                a.shape[0], a.shape[1], b.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def intersect_count(a, b, bounds=None, lbounds=None) -> torch.Tensor:
    """counts[i] = |{k ∈ A_i ∩ B_i : lbounds[i] < k < bounds[i]}|."""
    _check(a, b, bounds, lbounds)
    if a.device.type == "cpu":
        return intersect_count_ref(a, b, bounds, lbounds)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        _launch("repro_intersect_count", a, b, bounds, lbounds, counts)
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
        _launch("repro_intersect_expand", a, b, bounds, lbounds, mark, counts)
        intersect_expand.launches += 1
    return mark, counts


intersect_expand.launches = 0
