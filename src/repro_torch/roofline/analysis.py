"""Roofline terms of a traced step (NVIDIA H100 SXM data sheet constants).

The counterpart of ``repro.roofline.analysis``:

  compute term    = FLOPs / (chips x 989.4 TFLOP/s bf16 dense)
  memory term     = bytes / (chips x 3.35 TB/s HBM3)
  collective term = collective bytes / (chips x 450 GB/s NVLink, each way)

where the JAX package reads FLOPs and bytes from XLA's ``cost_analysis()``
and collective bytes from the compiled HLO text, the port counts them on
the aten ops a step dispatches (``CostCounter``, a ``TorchDispatchMode``):
FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products and
convolutions), bytes as each op's tensor inputs and outputs (unfused: every
elementwise op reads and writes its tensors, where XLA fuses them; views
move nothing), collectives as the result bytes of each c10d functional
collective. Under DTensor the mode sees each rank's local ops, so every
number is per device. The HLO-text parser (``collective_bytes`` of the JAX
package, over ``as_text()``) has no input in torch and is not ported, and
neither is the scan calibration: the port's units are a Python list, so
every unit is dispatched and counted.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 80GB HBM3 (SXM, 700.00 W), data sheet numbers."""
    flops: float = 989.4e12        # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12        # bytes/s HBM3
    ici_bw: float = 450e9          # bytes/s NVLink, each direction
    hbm_bytes: float = 80e9


H100 = HW()

# c10d functional collective -> the JAX package's HLO op name
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


def collective_bytes(records) -> dict[str, int]:
    """{collective op: summed result bytes} over ``records``, the
    (c10d functional op name, result bytes) pairs a ``CostCounter`` kept."""
    out: dict[str, int] = {}
    for op, nbytes in records:
        key = COLLECTIVES.get(op)
        if key is not None:
            out[key] = out.get(key, 0) + int(nbytes)
    return out


def model_flops_6nd(n_params: int, n_tokens: int,
                    n_active: int | None = None) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) — the useful-compute yardstick."""
    return 6.0 * float(n_active if n_active is not None else n_params) \
        * float(n_tokens)


def roofline_report(flops: float, bytes_hbm: float, coll: dict[str, int],
                    chips: int, hw: HW = H100, model_flops: float = 0.0,
                    per_device: bool = True) -> dict:
    """Three roofline terms in seconds + dominant bottleneck.

    ``per_device``: ``CostCounter``'s numbers under DTensor are per device
    (it sees each rank's local ops); set False if totals are global."""
    div = 1 if per_device else chips
    coll_total = float(sum(coll.values()))
    t_compute = flops / div / hw.flops
    t_memory = bytes_hbm / div / hw.hbm_bw
    t_coll = coll_total / div / hw.ici_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    out = dict(terms)
    out.update({
        "dominant": dominant,
        "collective_bytes": coll_total,
        "hlo_flops_per_chip": flops / div,
        "hlo_bytes_per_chip": bytes_hbm / div,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / chips / (flops / div)
                               if flops else 0.0),
        "bound_step_s": max(terms.values()),
        "roofline_fraction": (t_compute / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
    })
    return out


def _in_shape_propagation(depth: int = 40) -> bool:
    """Whether the caller runs inside DTensor's output-shape propagation
    (``ShardingPropagator._propagate_tensor_meta_non_cached``)."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f, depth = f.f_back, depth - 1
    return False


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it on plain tensors (real or
    fake; a DTensor op is left to DTensor, whose local ops then come here):
    ``flops`` (matrix products and convolutions), ``bytes`` (tensor inputs
    and outputs of every op but views and collectives), ``records`` (each c10d
    functional collective and its result bytes), ``ops``, and the live bytes
    of the storages the ops allocate (``live``, their high-water mark
    ``peak``), freed when the last tensor on a storage dies. The ops DTensor
    runs on fake global-shape tensors to find an op's output shape are not
    counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.records: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def _free(self, key: int, nbytes: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda r, k=key, n=nbytes: self._free(k, n, r))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.ops += 1
        if func.namespace == "_c10d_functional":
            name = func._schema.name.split("::")[-1]
            if name in COLLECTIVES:
                self.records.append((name, sum(t.nbytes for t in outs)))
        else:
            packet = func._overloadpacket
            if packet in self.registry:
                self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += sum(t.nbytes for t in ins + outs)
        for t in outs:
            self._track(t)
        return out
