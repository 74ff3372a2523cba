"""Production meshes over the current ``torch.distributed`` world.

The counterpart of ``repro.launch.mesh``. A mesh is a
``torch.distributed.DeviceMesh`` with the JAX package's shapes and axis
names, so every partition spec resolves leaf for leaf as the JAX package's.
Importing this module initialises no process group: the functions read the
world that ``torchrun`` (gloo on the CPU, NCCL on the card) or the dry run
(a ``fake`` group, ``launch/dryrun.py``) has set up.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import make_mining_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def device_mesh(shape, names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks of the
    current world."""
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    if not dist.is_initialized() or _world() < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs a world of {need} ranks, have {_world()}: start "
            f"it under torchrun, or through launch/dryrun.py (a fake world)")
    ranks = torch.arange(need).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16,16)=('data','model') single pod; (2,16,16)=('pod','data','model')
    two pods = 512 devices: the JAX package's TPU pod shapes, kept as they
    are so that every spec compares with its leaf for leaf. On H100s a
    16-wide 'model' axis spans two 8-GPU NVLink domains, so half of its
    traffic would cross the slower inter-node fabric."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return device_mesh(shape, names, device_type)


def make_host_mesh(model_parallel: int | None = None, device_type: str = "cuda"):
    """(world // mp, mp) ('data','model') over the ``torchrun`` world, or a
    one-device mesh of the same names when no process group is initialised
    (``device_type``: "cuda" for NCCL, "cpu" for gloo)."""
    mp = model_parallel or 1
    n = _world()
    if n % mp:
        raise ValueError(f"--model-parallel {mp} does not divide the world of {n}")
    if not dist.is_initialized():
        if mp != 1:
            raise RuntimeError(f"model_parallel {mp} needs a torchrun world of at least {mp}")
        from repro_torch.distributed.sharding import abstract_mesh
        return abstract_mesh((1, 1), ("data", "model"))
    return device_mesh((n // mp, mp), ("data", "model"), device_type)


def mesh_chips(mesh) -> int:
    """The number of devices of a ``DeviceMesh`` or an abstract mesh."""
    return int(mesh.size()) if callable(getattr(mesh, "size", None)) else int(mesh.size)


__all__ = ["make_host_mesh", "make_mining_mesh", "make_production_mesh", "mesh_chips",
           "device_mesh"]
