"""The mining mesh: one axis over a list of torch devices.

The counterpart of ``repro.distributed.sharding``'s ``make_mining_mesh``
(the LM partition rules of that module are not ported). The JAX package's
mesh is a ``jax.sharding.Mesh`` that ``shard_map`` runs one program over;
the port's is a plain list of devices that one host loop drives
(``mining.shard.ShardedWaveRunner``): each shard's launches go to its own
device, and the host blocks only where it reads a level's per-shard
totals. A device may stand in the list more than once (``[cuda:0] * 8``:
eight shards on one card), as XLA's forced host device count gives the
JAX package eight devices on one CPU.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: the axis name and one device a shard."""

    axis: str
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """{axis: shards}, as ``jax.sharding.Mesh.shape`` reads."""
        return {self.axis: len(self.devices)}


def _device(d) -> torch.device:
    """``d`` as a torch device; a bare "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mining_mesh(shards: int | None = None, axis: str = "mine", *, devices=None,
                     device_type: str = "cuda") -> Mesh:
    """1-D mesh for data-parallel pattern mining (``mining.shard``).

    ``devices`` lists the shards' devices and may repeat one; ``shards``
    takes its first ``shards``. Without ``devices`` the mesh takes the first
    ``shards`` cards (every visible card when ``shards`` is None) for
    ``device_type`` "cuda", and ``shards`` times the CPU for "cpu". A mesh
    that wants more cards than are visible raises: shards share a card
    only where ``devices`` says so.
    """
    if devices is not None:
        devs = [_device(d) for d in devices]
    elif device_type == "cpu":
        devs = [torch.device("cpu")] * (int(shards) if shards else 1)
    else:
        devs = [torch.device(device_type, i) for i in range(torch.cuda.device_count())]
    n = int(shards) if shards else len(devs)
    if n < 1:
        raise ValueError(f"mining mesh needs >= 1 shard, got {n}")
    if n > len(devs):
        raise ValueError(
            f"mining mesh wants {n} shards but has {len(devs)} device(s) "
            f"({'given' if devices is not None else 'visible'}); to put several "
            f"shards on one card pass devices= "
            f"(MinerConfig.mesh_devices), e.g. ('cuda:0',) * {n}")
    return Mesh(axis, tuple(devs[:n]))
