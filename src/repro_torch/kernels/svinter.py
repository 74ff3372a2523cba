"""Batched S_VINTER (the paper's SVPU, §IV-E) — a hand-written CUDA kernel
(``csrc/svinter.cu``) in place of the Pallas ``vinter_pallas`` of
``repro/kernels/svinter.py``:

    out[i] = Σ_{k ∈ A_i ∩ B_i} op(va, vb),   op 'mac' (va·vb), 'max', 'min'

``a_keys`` (B, cap_a) / ``b_keys`` (B, cap_b) are int32 rows, each a sorted
set padded with SENTINEL; ``a_vals`` / ``b_vals`` the f32 values beside
them. A SENTINEL slot of A never counts; there are no bounds. B's rows may
share one stream (row stride 0, ``Tensor.expand``), as ``sparse.ttv``'s
vector does.

``vinter_grid`` is the same kernel over every pair of two stacks, the form
``sparse.spmm`` calls once per (row block, column block):

    out[i, j] = Σ_{k ∈ A_i ∩ B_j} op(va, vb)      (nr, nc)

with no pair's rows copied (its plain version, ``vinter_grid_ref``, forms
the pairs with ``repeat_interleave`` / ``repeat`` as spmm did before).

The wrappers pick their path by the device of their tensors: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel on the current
stream, or raises. The kernel reads A's rows 16 bytes at a time, so on the
card A must start on a 16-byte boundary.
``vinter.launches`` and ``vinter_grid.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.batch import VINTER_OPS, batch_vinter
from repro_torch.core.stream import LANE

from .build import launch

OP_IDS = {op: i for i, op in enumerate(VINTER_OPS)}


def vinter_ref(a_keys, a_vals, b_keys, b_vals, op: str = "mac") -> torch.Tensor:
    """Plain torch version of ``vinter``."""
    return batch_vinter(a_keys, a_vals, b_keys, b_vals, op)


def vinter_grid_ref(a_keys, a_vals, b_keys, b_vals, op: str = "mac") -> torch.Tensor:
    """Plain torch version of ``vinter_grid``: ``batch_vinter`` over all
    (row, column) pairs, row-major."""
    nr, nc = a_keys.shape[0], b_keys.shape[0]
    return batch_vinter(a_keys.repeat_interleave(nc, dim=0),
                        a_vals.repeat_interleave(nc, dim=0), b_keys.repeat(nr, 1),
                        b_vals.repeat(nr, 1), op).view(nr, nc)


def _check_aligned(*tensors) -> None:
    """The kernel's 16-byte loads: on the card, rows start on that boundary."""
    for t in tensors:
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"a {tuple(t.shape)} tensor at storage offset "
                             f"{t.storage_offset()} is off a 16-byte boundary")


def _check_op(a_keys, op) -> None:
    if op not in OP_IDS:
        raise ValueError(f"unknown SVPU op {op!r}; use one of {VINTER_OPS}")
    if a_keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no vinter kernel for device {a_keys.device}")


def _check(a_keys, a_vals, b_keys, b_vals, op) -> None:
    """Raise on anything the kernel does not take."""
    _check_op(a_keys, op)
    B = a_keys.shape[0] if a_keys.dim() == 2 else -1
    for name, t, dtype in (("a_keys", a_keys, torch.int32), ("a_vals", a_vals, torch.float32),
                           ("b_keys", b_keys, torch.int32), ("b_vals", b_vals, torch.float32)):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != B or t.device != a_keys.device:
            raise ValueError(f"{name} must be a (B={B}, cap) {dtype} tensor on "
                             f"{a_keys.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape[1] % LANE:
            raise ValueError(f"{name} capacity {t.shape[1]} is not a multiple of {LANE}")
    if a_vals.shape != a_keys.shape or b_vals.shape != b_keys.shape:
        raise ValueError(f"values {tuple(a_vals.shape)}, {tuple(b_vals.shape)} do not "
                         f"match keys {tuple(a_keys.shape)}, {tuple(b_keys.shape)}")
    if not (a_keys.is_contiguous() and a_vals.is_contiguous()):
        raise ValueError("a_keys and a_vals must be contiguous")
    _check_aligned(a_keys, a_vals)
    if b_keys.stride() != b_vals.stride() or b_keys.stride(1) != 1 \
            or b_keys.stride(0) not in (0, b_keys.shape[1]):
        raise ValueError(f"b_keys and b_vals need one row stride, 0 or cap_b, and "
                         f"unit column stride; got {b_keys.stride()} and {b_vals.stride()}")


def vinter(a_keys, a_vals, b_keys, b_vals, op: str = "mac") -> torch.Tensor:
    """out (B,) f32: per row, the op-sum over value pairs of intersected keys."""
    _check(a_keys, a_vals, b_keys, b_vals, op)
    if a_keys.device.type == "cpu":
        return vinter_ref(a_keys, a_vals, b_keys, b_vals, op)
    out = torch.empty(a_keys.shape[0], dtype=torch.float32, device=a_keys.device)
    if a_keys.shape[0]:
        launch("svinter", "repro_vinter", a_keys.device,
               (a_keys, a_vals, b_keys, b_vals, out),
               (*a_keys.shape, b_keys.shape[1], b_keys.stride(0), OP_IDS[op]))
        vinter.launches += 1
    return out


vinter.launches = 0


def _check_grid(a_keys, a_vals, b_keys, b_vals, op) -> None:
    """Raise on anything the grid kernel does not take."""
    _check_op(a_keys, op)
    for name, t, like, dtype in (("a_keys", a_keys, a_keys, torch.int32),
                                 ("a_vals", a_vals, a_keys, torch.float32),
                                 ("b_keys", b_keys, b_keys, torch.int32),
                                 ("b_vals", b_vals, b_keys, torch.float32)):
        if t.dtype != dtype or t.dim() != 2 or t.shape != like.shape \
                or t.device != a_keys.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(like.shape)} {dtype} "
                             f"tensor on {a_keys.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.shape[1] % LANE:
            raise ValueError(f"{name} capacity {t.shape[1]} is not a multiple of {LANE}")
    _check_aligned(a_keys, a_vals)


def vinter_grid(a_keys, a_vals, b_keys, b_vals, op: str = "mac") -> torch.Tensor:
    """out (nr, nc) f32: for every pair of A row i and B row j, the op-sum
    over value pairs of their intersected keys."""
    _check_grid(a_keys, a_vals, b_keys, b_vals, op)
    if a_keys.device.type == "cpu":
        return vinter_grid_ref(a_keys, a_vals, b_keys, b_vals, op)
    nr, nc = a_keys.shape[0], b_keys.shape[0]
    out = torch.empty((nr, nc), dtype=torch.float32, device=a_keys.device)
    if nr and nc:
        launch("svinter", "repro_vinter_grid", a_keys.device,
               (a_keys, a_vals, b_keys, b_vals, out),
               (nr, nc, a_keys.shape[1], b_keys.shape[1], OP_IDS[op]))
        vinter_grid.launches += 1
    return out


vinter_grid.launches = 0
