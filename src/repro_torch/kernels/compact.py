"""Per-row stream compaction — a hand-written CUDA kernel
(``csrc/compact.cu``) in place of the Pallas ``compact_rows_pallas`` of
``repro/kernels/compact.py``:

    rows[i]   = the kept keys of a[i], in order, front-packed, SENTINEL
                after, cut at out_cap
    counts[i] = the number kept (not cut at out_cap)

A slot is kept where ``keep > 0`` and ``a != SENTINEL``: a kept SENTINEL
slot never counts, and a row with nothing kept gives count 0 and all
SENTINEL. ``a`` (B, cap) int32 rows are sorted sets padded with SENTINEL;
``keep`` (B, cap) is ``torch.bool`` (the engine's host-path keep masks) or
int32 (the mark kernel's output, which ``ops.xinter`` passes as it is).

The wrapper picks its path by the device of its tensors: a CPU tensor takes
the plain version (``compact_rows_ref`` = ``core.batch.batch_compact_rows``);
a CUDA tensor launches the kernel on the current stream, or raises. On the
card it also picks the kernel's team and loads: a warp a row for caps up to
``WARP_MAX_CAP``, else a block a row; 16-byte loads where ``cap`` is a
multiple of 4 and both arrays start on the boundary those loads need, else
four scalar loads a step (a view with a storage offset).
``compact_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import batch_compact_rows

from .build import launch

KEEP_BYTES = {torch.bool: 1, torch.int32: 4}
# rows of at most this many slots run a warp each (4 a block), longer rows a
# 256-thread block each: the switch measured by chip_smoke.py's team sweep
WARP_MAX_CAP = 1024


def compact_rows_ref(a, keep, out_cap: int):
    """Plain torch version of ``compact_rows``."""
    return batch_compact_rows(a, keep if keep.dtype == torch.bool else keep > 0, out_cap)


def _check(a, keep, out_cap) -> None:
    """Raise on anything the kernel does not take."""
    if a.dtype != torch.int32 or a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous 2-D int32 tensor, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if keep.dtype not in KEEP_BYTES or keep.shape != a.shape \
            or not keep.is_contiguous() or keep.device != a.device:
        raise ValueError(f"keep must be a contiguous bool or int32 {tuple(a.shape)} "
                         f"tensor on {a.device}, got {keep.dtype} {tuple(keep.shape)} "
                         f"on {keep.device}")
    if out_cap < 1 or a.shape[1] < 1:
        raise ValueError(f"need out_cap >= 1 and cap >= 1, got {out_cap} and {a.shape[1]}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compact kernel for device {a.device}")


def compact_rows(a, keep, out_cap: int):
    """Front-pack each row's kept keys -> (rows (B, out_cap) int32,
    counts (B,) int32)."""
    _check(a, keep, out_cap)
    if a.device.type == "cpu":
        return compact_rows_ref(a, keep, out_cap)
    rows = torch.empty((a.shape[0], out_cap), dtype=torch.int32, device=a.device)
    counts = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    if a.shape[0]:
        cap, nbytes = a.shape[1], KEEP_BYTES[keep.dtype]
        vec = cap % 4 == 0 and a.data_ptr() % 16 == 0 \
            and keep.data_ptr() % (4 * nbytes) == 0
        launch("compact", "repro_compact_rows", a.device, (a, keep, rows, counts),
               (*a.shape, out_cap, nbytes, int(cap <= WARP_MAX_CAP), int(vec)))
        compact_rows.launches += 1
    return rows, counts


compact_rows.launches = 0
