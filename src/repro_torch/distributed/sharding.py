"""Logical-axis sharding rules with divisibility-aware resolution, and the
mining mesh.

The counterpart of ``repro.distributed.sharding``. Every parameter,
activation and cache leaf carries *logical* axis names (``Axes('experts',
'd_ff', 'embed')``, ...). ``ShardingRules`` maps logical names to mesh axes;
resolution drops a mesh axis whenever the dimension does not divide the
axis size (4 KV heads on a 16-way 'model' axis: replicated), so every
config resolves on every mesh without hand-tuning. The rules, the
resolution and the ``PartitionSpec`` it returns are the JAX package's entry
for entry (``tuple(spec)`` compares equal).

Meshes (``launch/mesh.py``):
  single pod  (16, 16)      axes ('data', 'model')
  multi pod   (2, 16, 16)   axes ('pod', 'data', 'model')

Conventions:
  batch      -> ('pod', 'data')   pure DP
  embed      -> None (replicated); FSDP_RULES shards it over ('data',)
  heads/q    -> 'model'           Megatron TP
  kv_heads   -> 'model' (drops to replication when #kv % axis != 0)
  d_ff       -> 'model'
  experts    -> 'model'           expert parallelism
  vocab      -> 'model'           sharded embeddings + logits
  kv_seq     -> 'model'           sequence-sharded decode KV caches

The JAX ``NamedSharding(mesh, P(...))`` is here ``NamedSharding(mesh,
spec)`` whose ``placements`` are DTensor placements over a
``torch.distributed.DeviceMesh`` with those dimension names: for each mesh
dimension, ``Shard(d)`` where the spec puts that mesh axis on tensor
dimension ``d``, else ``Replicate()``. A tensor dimension sharded over two
mesh axes takes two ``Shard(d)`` placements, which DTensor nests in
mesh-dimension order; the spec may name them the other way round (the
ZeRO 'opt' rule is ('data', 'pod')). The devices then hold the blocks in
another order than XLA's, and each device holds as many bytes either way.
``jax.jit(in_shardings=...)`` becomes DTensor parameters, state and batch
(``distribute``), and ``with_sharding_constraint`` ``DTensor.redistribute``
(``constrain``). ``make_mesh_compat`` (a shim over jax versions) has no
counterpart.

The mining mesh is another thing: the JAX package's is a
``jax.sharding.Mesh`` that ``shard_map`` runs one program over; the port's
is a plain list of devices that one host loop drives
(``mining.shard.ShardedWaveRunner``): each shard's launches go to its own
device, and the host blocks only where it reads a level's per-shard totals.
A device may stand in the list more than once (``[cuda:0] * 8``: eight
shards on one card), as XLA's forced host device count gives the JAX
package eight devices on one CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


class Axes(tuple):
    """Logical axes annotation of one parameter or cache leaf
    (``Axes("embed", "heads", "head_dim")``): a tuple of names, None for an
    axis with no logical name."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


def is_axes(x) -> bool:
    return isinstance(x, Axes)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a tensor dimension, each a
    mesh axis name, a tuple of names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices and no process group: all that
    resolution reads (``jax.sharding.AbstractMesh``)."""

    axis_shapes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shapes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shapes)


def abstract_mesh(axis_shapes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_shapes), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (str), tuple of mesh axes, or None."""

    rules: dict

    def get(self, name: str):
        return self.rules.get(name, None)

    def replace(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)


DEFAULT_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "kv_seq": "model",          # decode caches: sequence-sharded (flash-decode)
    "state": None,              # SSM / RWKV recurrent state dims
    "conv": None,
    "opt": ("data", "pod"),     # ZeRO extra sharding for optimizer state
    "moe_groups": ("pod", "data"),  # sort-dispatch token groups (local sort)
    "moe_cap": ("pod", "data"),     # expert capacity dim after the a2a
    "bh": ("pod", "data", "model"),  # merged batch x heads (rwkv wkv)
})

FSDP_RULES = DEFAULT_RULES.replace(embed=("data",))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of an ``AbstractMesh``, a ``DeviceMesh`` or the
    mining ``Mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh: shape is a tuple
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_to_physical(axes: Axes, mesh, rules: ShardingRules,
                        shape: tuple | None = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec, dropping non-dividing axes
    and giving each mesh axis to the first dimension that asks for it."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    spec = []
    for d, name in enumerate(axes):
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            spec.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = []
        prod = 1
        for ax in mesh_axes:
            if ax not in sizes or ax in used:
                continue
            nxt = prod * sizes[ax]
            if shape is not None and shape[d] % nxt != 0:
                continue
            picked.append(ax)
            prod = nxt
        used.update(picked)
        spec.append(tuple(picked) if len(picked) > 1
                    else (picked[0] if picked else None))
    return PartitionSpec(*spec)


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``'s dimensions (see the
    module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                where[ax] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in axis_sizes(mesh))


def shard_shape(spec, mesh, shape) -> tuple:
    """The per-device block shape of a ``shape`` leaf under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[d] //= sizes[ax]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec; ``placements``
    for DTensor."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        return shard_shape(self.spec, self.mesh, shape)


def named_sharding(axes: Axes, mesh, rules: ShardingRules,
                   shape: tuple | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_physical(axes, mesh, rules, shape))


def _tree_pairs(shapes, axes, fn):
    """``fn(leaf, axes)`` over two trees of one structure (nested dicts and
    lists; the Axes tree's leaves are Axes)."""
    if isinstance(shapes, dict):
        return {k: _tree_pairs(shapes[k], axes[k], fn) for k in shapes}
    if isinstance(shapes, (list, tuple)) and not is_axes(axes):
        return [_tree_pairs(s, a, fn) for s, a in zip(shapes, axes)]
    return fn(shapes, axes)


def shard_params_tree(param_shapes, param_axes, mesh, rules: ShardingRules):
    """Tensor (meta or real) tree + Axes tree -> NamedSharding tree."""
    return _tree_pairs(param_shapes, param_axes,
                       lambda s, a: named_sharding(a, mesh, rules, tuple(s.shape)))


def input_sharding(mesh, rules: ShardingRules, *names) -> NamedSharding:
    return named_sharding(Axes(*names), mesh, rules)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole leaf, the same on every rank) as a DTensor under
    ``sharding`` over its ``DeviceMesh`` (see ``place``)."""
    return place(t, sharding.mesh, sharding.placements)


def place(t: torch.Tensor, mesh, placements):
    """``t`` (the whole value, the same on every rank) as a DTensor of
    ``placements`` over ``mesh``: each rank keeps a copy of its block (not
    a view, which would keep the whole value alive), and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    dt = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().nbytes() == local.nbytes and local.is_contiguous():
        return dt
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), dt.device_mesh,
                              dt.placements, shape=dt.shape, stride=dt.stride())


# ---------------------------------------------------------------------------
# mesh context: lets model code write constrain(x, 'batch','seq','embed')
# without plumbing the mesh through every function signature.
# ---------------------------------------------------------------------------

# Process-wide, not thread-local as the JAX package's: torch's autograd
# engine runs a CUDA backward, and with it the checkpointed units' recompute,
# on threads of its own, which must see the step's context.
_CTX: dict = {"ctx": None, "dp": None, "tp": None}


@contextlib.contextmanager
def mesh_context(mesh, rules: ShardingRules = DEFAULT_RULES):
    prev = _CTX["ctx"]
    _CTX["ctx"] = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _CTX["ctx"] = prev


def current_mesh():
    ctx = _CTX["ctx"]
    return ctx if ctx is not None else (None, DEFAULT_RULES)


def _redistribute(x, axes: Axes, mesh, rules: ShardingRules):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x                       # a rank-local tensor: nothing to constrain
    spec = logical_to_physical(axes, mesh, rules, tuple(x.shape))
    placements = spec_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, *names):
    """Logical sharding constraint: ``x`` itself when no mesh context is
    active (or ``x`` is not a DTensor), else ``x`` redistributed to the
    placements its names resolve to."""
    mesh, rules = current_mesh()
    if mesh is None:
        return x
    return _redistribute(x, Axes(*names), mesh, rules)


def with_sharding_constraint(x, axes: Axes, mesh=None,
                             rules: ShardingRules = DEFAULT_RULES):
    if mesh is None:
        return constrain(x, *axes)
    return _redistribute(x, axes, mesh, rules)


# ---------------------------------------------------------------------------
# data parallelism: what the sharded train step's model code reduces over
# ---------------------------------------------------------------------------


class DataParallel:
    """The mesh dimensions a batch is sharded over (``dims``, in mesh
    order): each rank runs the model on its block of the batch, and the few
    quantities that span the whole batch (the loss's sums and counts, the
    MoE router's balance statistics and capacity ranks) are reduced over
    these dimensions' process groups, so every rank computes the one-device
    model's global values. ``rank`` is the rank's index among the blocks
    (the batch dimension's block order), ``size`` their number."""

    def __init__(self, mesh, dims: tuple):
        self.mesh = mesh
        self.dims = tuple(dims)
        sizes = axis_sizes(mesh)
        self.size = math.prod(sizes[d] for d in self.dims)
        rank = 0
        for d in self.dims:
            rank = rank * sizes[d] + mesh.get_local_rank(d)
        self.rank = rank

    def _groups(self):
        return [self.mesh.get_group(d) for d in self.dims]

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the data-parallel ranks (no autograd)."""
        f = torch.ops._c10d_functional
        for g in self._groups():
            x = f.wait_tensor(f.all_reduce(x, op, g.group_name))
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data-parallel ranks; its backward passes
        the gradient through unchanged, because every rank computes the same
        function of the sum and owns its own summand."""
        return _DPSum.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x`` in block order (no autograd)."""
        f = torch.ops._c10d_functional
        out = x.unsqueeze(0)
        for g, d in reversed(list(zip(self._groups(), self.dims))):
            n = axis_sizes(self.mesh)[d]
            out = f.wait_tensor(f.all_gather_into_tensor(out.contiguous(), n, g.group_name))
        return out


class _DPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        return dp.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def data_parallel(dp: DataParallel | None):
    prev = _CTX["dp"]
    _CTX["dp"] = dp
    try:
        yield
    finally:
        _CTX["dp"] = prev


def current_dp() -> DataParallel | None:
    """The active ``DataParallel``, None outside the sharded step."""
    return _CTX["dp"]


# ---------------------------------------------------------------------------
# tensor parallelism: the 'model' dimension splits heads, d_ff and experts
# ---------------------------------------------------------------------------


class TensorParallel:
    """Megatron's tensor parallelism over the mesh dimension ``dim``: a block
    whose parameters split over it (heads, d_ff or experts: ``TPParams``)
    runs on this rank's share of them. ``enter`` marks the block's input
    (the identity; its backward sums the gradient over the dimension, each
    rank having its share of it) and ``leave`` its output (the sum over the
    dimension of each rank's partial output; its backward the identity).
    ``rank`` and ``size`` are the rank's index along the dimension and its
    length."""

    def __init__(self, mesh, dim: str = "model"):
        self.dim = dim
        self.index = list(mesh.mesh_dim_names).index(dim)
        self.group = DataParallel(mesh, (dim,))
        self.size, self.rank = self.group.size, self.group.rank

    def splits(self, p, tensor_dim: int) -> bool:
        """Whether the DTensor ``p`` is split over ``dim`` on ``tensor_dim``."""
        pl = p.placements[self.index]
        return pl.is_shard() and pl.dim == tensor_dim

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _TPEnter.apply(x, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return self.group.sum(y)


class _TPEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


class TPParams(dict):
    """A block's parameters as the sharded step gathers them for tensor
    parallelism: each one split over the 'model' dimension is this rank's
    block of it, each other one whole behind ``TensorParallel.enter``."""


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    prev = _CTX["tp"]
    _CTX["tp"] = tp
    try:
        yield
    finally:
        _CTX["tp"] = prev


def current_tp() -> TensorParallel | None:
    """The active ``TensorParallel``, None outside the sharded step."""
    return _CTX["tp"]


# ---------------------------------------------------------------------------
# the mining mesh
# ---------------------------------------------------------------------------


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
