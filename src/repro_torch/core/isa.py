"""IntersectX stream ISA (Table I of the paper) on ``Stream``s of torch tensors.

The counterpart of ``repro.core.isa``, with the same bound semantics (the
R3 operand, §III-B): results hold only keys strictly below ``bound``;
``bound=None`` (the paper's -1) means unbounded, i.e. SENTINEL. A bound is
an int or a 0-d tensor on the streams' device. Output capacities follow
the paper's dependency-tracking property |A∩B| <= min(|A|, |B|) (§IV-D).

In the JAX package these are XLA ops. Here each op is a one-row batch
through the kernel wrapper that computes it (``kernels.ops``), which picks
its path by the device of the streams: a CPU stream takes the wrapper's
plain torch version, a CUDA stream launches the hand-written kernel.

  ``s_inter_c``  ``ops.xinter_count``   the count kernel
  ``s_inter``    ``ops.xinter``         the mark kernel, then compact-rows
  ``s_sub_c``    ``ops.xsub_count``     the mark kernel, unbounded
  ``s_sub``      ``ops.xsub``           the mark kernel, then compact-rows
  ``s_vinter``   ``ops.xvinter``        the S_VINTER kernel (paired form)

``s_fetch`` and ``s_union_count`` are a gather and an add on the device.
"""
from __future__ import annotations

import torch

from .batch import VINTER_OPS
from .stream import SENTINEL, Stream

__all__ = ["VINTER_OPS", "s_fetch", "s_inter", "s_inter_c", "s_sub", "s_sub_c",
           "s_union_count", "s_vinter"]


def _ops():
    # deferred: the kernel layer sits above core
    from repro_torch.kernels import ops
    return ops


def _bound_row(bound, s: Stream) -> torch.Tensor | None:
    """The bound as the kernels' (1,) int32 row; None stays None (SENTINEL)."""
    if bound is None:
        return None
    return torch.as_tensor(bound, dtype=torch.int32, device=s.device).reshape(1)


# ----------------------------------------------------------------------------
# S_INTER / S_INTER.C
# ----------------------------------------------------------------------------

def s_inter(a: Stream, b: Stream, bound=None) -> Stream:
    """S_INTER: out = {k in A ∩ B : k < bound}, capacity = min(capA, capB)."""
    rows, counts = _ops().xinter(a.keys[None], b.keys[None], _bound_row(bound, a),
                                 min(a.capacity, b.capacity))
    return Stream(keys=rows[0], length=counts[0])


def s_inter_c(a: Stream, b: Stream, bound=None) -> torch.Tensor:
    """S_INTER.C: |{k in A ∩ B : k < bound}| (count only, no output stream)."""
    return _ops().xinter_count(a.keys[None], b.keys[None], _bound_row(bound, a))[0]


# ----------------------------------------------------------------------------
# S_SUB / S_SUB.C
# ----------------------------------------------------------------------------

def s_sub(a: Stream, b: Stream, bound=None) -> Stream:
    """S_SUB: out = {k in A \\ B : k < bound}, capacity = capA."""
    rows, counts = _ops().xsub(a.keys[None], b.keys[None], _bound_row(bound, a),
                               a.capacity)
    return Stream(keys=rows[0], length=counts[0])


def s_sub_c(a: Stream, b: Stream, bound=None) -> torch.Tensor:
    """S_SUB.C: |{k in A \\ B : k < bound}|."""
    return _ops().xsub_count(a.keys[None], b.keys[None], _bound_row(bound, a))[0]


# ----------------------------------------------------------------------------
# S_VINTER — sparse computation on values (SVPU, §IV-E)
# ----------------------------------------------------------------------------

def s_vinter(a: Stream, b: Stream, op: str = "mac") -> torch.Tensor:
    """S_VINTER: intersect keys, reduce over aligned value pairs.

    op='mac' : Σ va·vb   (sparse dot product)
    op='max' : Σ max(va, vb)
    op='min' : Σ min(va, vb)
    """
    if a.values is None or b.values is None:
        raise TypeError("S_VINTER requires (key,value) streams (paper: exception)")
    if op not in VINTER_OPS:
        raise ValueError(f"unknown SVPU op {op!r}; supported: {VINTER_OPS}")
    return _ops().xvinter(a.keys[None], a.values[None], b.keys[None], b.values[None], op)[0]


# ----------------------------------------------------------------------------
# S_FETCH — stream element access
# ----------------------------------------------------------------------------

def s_fetch(s: Stream, offset) -> torch.Tensor:
    """S_FETCH: s.keys[offset], or SENTINEL ("EOS") past the end."""
    offset = torch.as_tensor(offset, dtype=torch.int32, device=s.device)
    key = s.keys[offset.clamp(0, s.capacity - 1).long()]
    return torch.where(offset < s.length, key, SENTINEL)


# ----------------------------------------------------------------------------
# derived helpers used across mining apps
# ----------------------------------------------------------------------------

def s_union_count(a: Stream, b: Stream) -> torch.Tensor:
    """|A ∪ B| = |A| + |B| - |A ∩ B| (not a paper instruction; test invariant)."""
    return a.length + b.length - s_inter_c(a, b)
