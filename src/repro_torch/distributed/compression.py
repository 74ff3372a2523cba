"""int8-compressed cross-pod gradient mean with error feedback.

The counterpart of ``repro.distributed.compression``. Data-parallel
gradient synchronisation dominates the multi-pod collective budget (the
'pod' axis rides the slow inter-pod links). That hop is compressed:
per-tensor int8 quantisation, the sum taken in int32, the scales' MAX as
the shared dequantisation scale, and the quantisation residual kept locally
as an error-feedback buffer for the next step (so compression error does
not bias the optimizer, only delays information). Rounding is half to even,
as in the JAX package.

Where the JAX package binds an axis name inside ``shard_map`` and reduces
with ``psum``/``pmax``, the port reduces over a ``torch.distributed`` process
group (a ``DeviceMesh`` dimension's ``get_group(name)``) with the functional
collectives, which run under fake tensors too. The intra-pod ('data')
reduction stays full precision.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def _quant(x: torch.Tensor, scale: torch.Tensor | None = None):
    if scale is None:
        scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _group(group):
    return group if group is not None else dist.group.WORLD


def compressed_mean(x: torch.Tensor, group=None, err: torch.Tensor | None = None,
                    scale: torch.Tensor | None = None):
    """Mean over the ranks of ``group`` (default: the world) of x (+err),
    int8 on the wire. Every rank of the group calls it. ``scale`` is the
    quantisation scale where x is this rank's block of a larger tensor
    whose scale every block must share (the whole tensor's max |x| / 127 +
    1e-12); None: x's own. Returns (mean in x's dtype, new_err in float32)."""
    group = _group(group)
    n = dist.get_world_size(group)
    xf = x.float()
    if err is not None:
        xf = xf + err
    q, scale = _quant(xf, scale)
    total = funcol.all_reduce(q.to(torch.int32), "sum", group)
    scale_max = funcol.all_reduce(scale, "max", group)   # shared dequant scale
    mean = (total.float() * scale_max) / n
    new_err = xf - q.float() * scale                      # local residual
    return mean.to(x.dtype), new_err


def tree_compressed_mean(grads, mesh, axis_name: str, err_tree=None):
    """Compressed-mean every leaf of a nested dict/list of tensors over the
    ``axis_name`` dimension of the ``DeviceMesh`` ``mesh``; the leaves are
    each rank's own values (replicated within its region). Returns the tree
    of means (the residuals are dropped, as the JAX package drops them)."""
    group = mesh.get_group(axis_name)

    def walk(t, e):
        if isinstance(t, dict):
            return {k: walk(v, None if e is None else e[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, None if e is None else e[i]) for i, v in enumerate(t)]
        return compressed_mean(t, group, e)[0]
    return walk(grads, err_tree)
