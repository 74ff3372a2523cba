"""The train step: forward, backward, global norm and schedule, then the
AdamW update in place once the caller has accepted the step; on one device
or sharded over a ``DeviceMesh``.

The counterpart of ``repro.train.train_step``. The JAX step returns new
(params, opt_state) trees and its launcher keeps the old ones alive until
``StepGuard`` accepts the metrics; the port's model and state are updated in
place, so the step is split in two: ``step(opt_state, batch, step)`` leaves
the grads on the parameters and returns the metrics, and
``step.apply(opt_state, metrics)`` updates. A step the guard rejects is
never applied: parameters, moments and count stay as they were.

``jit_train_step`` is the sharded step's entry point, as the JAX
package's. On a mesh of one device it returns the one-device ``TrainStep``
(a mesh of one device shards nothing). On a larger mesh it returns a
``ShardedTrainStep``:

- storage: every parameter is a DTensor under the partition rules' spec
  (``shard_params_tree`` over the port's per-unit leaves), the AdamW state a
  DTensor under ZeRO's (``opt_state_shardings``), the batch a DTensor over
  ('pod', 'data'): each device holds the bytes the JAX step's arguments
  hold there;
- compute: data parallel over the mesh dimensions the batch is sharded on,
  tensor parallel over 'model'. Each rank runs the model on its block of
  the batch. The loss's sums and the MoE router's statistics are summed
  over the data-parallel dimensions (``sharding.DataParallel``), so every
  rank computes the one-device loss. Each attention, cross-attention, MLP
  and MoE block whose heads, d_ff or experts split over 'model' runs on
  this rank's share of them (``sharding.TensorParallel``, Megatron's split:
  column-parallel q/k/v, gate and up, row-parallel wo and down, experts
  whole to one rank, their outputs summed over 'model'), as the JAX step's
  per-head and per-expert splits do; so do the embedding lookup and the
  loss's logits where the vocabulary splits (the logsumexp's sum and the
  gold logit summed over 'model'). Every other parameter (norms, the MoE
  router, Mamba, RWKV, and a block whose dimension does not divide) is
  gathered whole at its use and computed whole on each rank. Gathers run
  inside a unit's checkpointed call, so one unit is gathered at a time,
  and again in its recompute; a gathered parameter's gradient is summed
  over the data-parallel dimensions (and over 'model' for a whole one read
  inside a split block) and each rank keeps its block;
- the update: each rank updates its ZeRO block of the 32-bit state alone
  (elementwise, so the same arithmetic as one device), then the parameter
  is gathered back to its own placements. 8-bit state is quantised in
  blocks of the whole leaf, as on one device: each rank updates the whole
  leaf and keeps its block.

``compress_pods=True`` (``jit_train_step`` and both steps; default False)
is the JAX step's flag: on a mesh with a 'pod' dimension, every gradient
leaf goes through ``distributed.compression.compressed_mean`` over the
'pod' group once the gradient is complete (after the data-parallel sums),
before ``global_norm`` and the update. The JAX step's ``shard_map`` receives
the whole, replicated gradient, so each leaf is quantised with the scale of
the JAX tree's whole leaf: the port's units of a stacked leaf share it, and
where a rank holds a block, its max is taken over the ranks holding the
other blocks. On a one-device mesh it is each leaf's int8 round trip, as in
the JAX step.

The loss, ``global_norm`` and the update equal the one-device step's up to
the order of the sums over ranks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.compression import compressed_mean
from repro_torch.distributed.sharding import (DEFAULT_RULES, Axes, DataParallel, ShardingRules,
                                              TensorParallel, _tree_pairs, axis_sizes,
                                              data_parallel, distribute, mesh_context,
                                              named_sharding, place, shard_params_tree,
                                              tensor_parallel)
from repro_torch.models.convert import _grouped
from .optimizer import (OptConfig, _adam_, _dequantize, _groups, _quantize, _state_leaves,
                        adamw_apply_, global_norm, opt_state_shardings, tree_leaves, tree_map)


def lr_schedule(step, base_lr: float, warmup: int = 100,
                total: int = 10_000, min_frac: float = 0.1, device=None):
    """Linear warmup then cosine decay to ``min_frac``, in float32 (a 0-d
    tensor on ``device``), as XLA computes the JAX package's."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def _pod_group(mesh, compress_pods: bool):
    """The process group of ``mesh``'s 'pod' dimension when the gradient is
    compressed over it, else None."""
    if compress_pods and mesh is not None and "pod" in (mesh.mesh_dim_names or ()):
        return mesh.get_group("pod")
    return None


class TrainStep:
    """``model``'s train step under ``opt_cfg`` and the schedule of
    ``total_steps``. Call it for the metrics, then ``apply`` them.
    ``compress_pods`` over ``mesh``'s 'pod' dimension: see the module
    docstring."""

    def __init__(self, model, opt_cfg: OptConfig = OptConfig(), total_steps: int = 10_000,
                 mesh=None, compress_pods: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self.total_steps = total_steps
        self.pod_group = _pod_group(mesh, compress_pods)

    def __call__(self, opt_state: dict, batch: dict, step) -> dict:
        """``model.loss(batch)`` and its grads, left on the parameters (those
        of the previous step dropped first): {"loss", "gnorm", "lr"}, float32
        0-d tensors on the model's device. Nothing is updated."""
        model = self.model
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        if self.pod_group is not None:
            self._compress_pods_()
        gnorm = global_norm(tree_leaves(self._grads()))
        lr = lr_schedule(step, self.opt_cfg.lr, total=self.total_steps, device=model.device)
        return {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}

    def _compress_pods_(self) -> None:
        """Each gradient leaf through ``compressed_mean`` over the 'pod'
        group, in place, at the scale of the JAX tree's leaf: the max over
        the units that it stacks into one leaf (and, sharded, over the ranks
        holding its other blocks). A leaf the loss does not reach keeps no
        gradient: the round trip of its zero gradient is zero."""
        with torch.no_grad():
            for _, leaves in _grouped(self.model.tree()).values():
                blocks = [self._block(p.grad) for p in leaves if p.grad is not None]
                if not blocks:
                    continue
                amax = self._leaf_max(torch.stack([b.float().abs().max() for b in blocks]).max())
                for b in blocks:
                    b.copy_(compressed_mean(b, self.pod_group, scale=amax / 127.0 + 1e-12)[0])

    def _block(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's block of the gradient ``g``, which it may write."""
        return g

    def _leaf_max(self, m: torch.Tensor) -> torch.Tensor:
        """The max of a leaf from this rank's max of its blocks."""
        return m

    def _grads(self):
        # a parameter the loss does not reach has a zero gradient, as in JAX
        return tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                        self.model.tree())

    def apply(self, opt_state: dict, metrics: dict) -> None:
        """The AdamW update of the step that gave ``metrics``, in place on the
        model's parameters and ``opt_state``; the grads are dropped after."""
        adamw_apply_(self.model.tree(), self._grads(), opt_state, metrics["lr"],
                     metrics["gnorm"], self.opt_cfg)
        self.model.zero_grad(set_to_none=True)


def make_train_step(model, opt_cfg: OptConfig = OptConfig(),
                    total_steps: int = 10_000) -> TrainStep:
    """The one-device train step of ``model`` (see ``TrainStep``)."""
    return TrainStep(model, opt_cfg, total_steps)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def model_axes(model) -> dict:
    """The ``Axes`` tree of ``model.tree()`` (units and encoder as lists of
    per-unit trees, no G axis)."""
    from repro_torch.models.transformer import STACKED, init_params
    _, axes = init_params(model.cfg, None)
    for k in STACKED:
        if k in axes:
            axes[k] = [axes[k]] * len(getattr(model, k))
    return axes


def shardings_for(model, mesh, rules: ShardingRules = DEFAULT_RULES,
                  opt_cfg: OptConfig = OptConfig()):
    """(param_shardings, opt_shardings, param_shapes, axes) for a model in
    the JAX layout (``shapes_and_axes``: units stacked on G), as the JAX
    package's: the specs to compare, and the argument bytes a device holds."""
    from repro_torch.models.transformer import shapes_and_axes
    shapes, axes = shapes_and_axes(model)
    p_shard = shard_params_tree(shapes, axes, mesh, rules)
    o_shard = opt_state_shardings(shapes, axes, mesh, rules, opt_cfg)
    return p_shard, o_shard, shapes, axes


def batch_shardings(batch_spec: dict, mesh, rules=DEFAULT_RULES) -> dict:
    """Shard every batch input over ('pod','data') on dim 0 — except
    M-RoPE positions whose batch dim is dim 1."""
    out = {}
    for k, v in batch_spec.items():
        if k == "mrope_positions":
            out[k] = named_sharding(Axes(None, "batch", None), mesh, rules, tuple(v.shape))
        else:
            names = ("batch",) + (None,) * (len(v.shape) - 1)
            out[k] = named_sharding(Axes(*names), mesh, rules, tuple(v.shape))
    return out


def tree_shard_bytes(shapes, shardings) -> int:
    """Sum over the leaves of a tree of tensors (``meta`` ones will do) of
    the bytes one device holds under the matching NamedSharding tree."""
    return sum(math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
               for t, sh in zip(tree_leaves(shapes), tree_leaves(shardings), strict=True))


def _param_slots(model):
    """(owner module, name, leaf path in ``model.tree()``) of every parameter."""
    for name, _ in list(model.named_parameters()):
        *mods, leaf = name.split(".")
        m = model
        for x in mods:
            m = m[int(x)] if x.isdigit() else getattr(m, x)
        yield m, leaf, [int(x) if x.isdigit() else x for x in name.split(".")]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def distribute_model_(model, param_shardings) -> None:
    """Replace each parameter of ``model`` (the whole value, the same on
    every rank) by a DTensor parameter under its sharding; each rank keeps
    its block. A parameter that is a DTensor already is left as it is."""
    from torch.distributed.tensor import DTensor
    for owner, leaf, path in _param_slots(model):
        p = owner._parameters[leaf]
        if not isinstance(p, DTensor):
            owner._parameters[leaf] = torch.nn.Parameter(
                distribute(p.detach(), _at(param_shardings, path)), requires_grad=p.requires_grad)


def _reshard(x, placements):
    """``x`` (a DTensor) under ``placements``: DTensor's redistribute, through
    Replicate where a mesh dimension moves a shard from one tensor dimension
    to another (no all-to-all, which gloo lacks)."""
    from torch.distributed.tensor import Replicate
    src, placements = tuple(x.placements), tuple(placements)
    if src == placements:
        return x
    if not all(a == b or a.is_replicate() or b.is_replicate() for a, b in zip(src, placements)):
        x = x.redistribute(x.device_mesh, [Replicate()] * len(src))
    return x.redistribute(x.device_mesh, placements)


class _Gather(torch.autograd.Function):
    """A DTensor parameter's value gathered over every mesh dimension but
    the ones ``keep`` names a placement for (None: its whole value); the
    backward sums the value's gradient over the data-parallel ranks and
    keeps this rank's block, under the parameter's placements."""

    @staticmethod
    def forward(ctx, p, step, keep):
        ctx.p, ctx.step, ctx.keep = p, step, keep
        return p.full_tensor() if keep is None else _reshard(p, keep).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        p = ctx.p
        g = ctx.step.dp.all_reduce(g.contiguous())
        if ctx.keep is None:
            return place(g, p.device_mesh, p.placements), None, None
        g = DTensor.from_local(g, p.device_mesh, ctx.keep, shape=p.shape, stride=p.stride())
        return _reshard(g, p.placements), None, None


class ShardedTrainStep(TrainStep):
    """The train step of ``model`` over the ``DeviceMesh`` ``mesh`` under
    ``rules`` (see the module docstring). Building it distributes the
    model's parameters in place; ``init_state()`` gives the sharded AdamW
    state, ``shard_batch`` a batch's DTensors. Call and ``apply`` as
    ``TrainStep``."""

    def __init__(self, model, mesh, rules: ShardingRules = DEFAULT_RULES,
                 opt_cfg: OptConfig = OptConfig(), total_steps: int = 10_000,
                 compress_pods: bool = False):
        super().__init__(model, opt_cfg, total_steps, mesh, compress_pods)
        self.mesh, self.rules = mesh, rules
        axes = model_axes(model)
        tree = model.tree()
        self.param_shardings = shard_params_tree(tree, axes, mesh, rules)
        self.opt_shardings = opt_state_shardings(tree, axes, mesh, rules, opt_cfg)
        distribute_model_(model, self.param_shardings)
        model.gather = self._gather
        self.dp = None
        self.tp = TensorParallel(mesh) if axis_sizes(mesh).get("model", 1) > 1 else None

    # ---------------- the step ----------------
    def _gather(self, p, tp: bool = False):
        """``p``'s whole value; with ``tp`` (a ``TPParams`` block's
        parameter), this rank's block of it where it splits over 'model',
        else the whole value behind ``TensorParallel.enter``."""
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(p, DTensor):
            return p
        if not tp:
            return _Gather.apply(p, self, None)
        i = self.tp.index
        if p.placements[i].is_shard():
            keep = tuple(pl if j == i else Replicate() for j, pl in enumerate(p.placements))
            return _Gather.apply(p, self, keep)
        return self.tp.enter(_Gather.apply(p, self, None))

    def shard_batch(self, batch: dict) -> dict:
        """The batch (whole tensors, the same on every rank, or DTensors) as
        DTensors under ``batch_shardings``."""
        from torch.distributed.tensor import DTensor
        sh = batch_shardings(batch, self.mesh, self.rules)
        return {k: v if isinstance(v, DTensor) else distribute(v, sh[k])
                for k, v in batch.items()}

    def data_parallel(self, batch: dict) -> DataParallel:
        """The mesh dimensions ``batch``'s tokens are sharded over."""
        spec = batch_shardings({"tokens": batch["tokens"]}, self.mesh, self.rules)["tokens"].spec
        entry = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        return DataParallel(self.mesh, tuple(d for d in self.mesh.mesh_dim_names if d in entry))

    def __call__(self, opt_state: dict, batch: dict, step) -> dict:
        """The loss of the whole batch and its grads, left on the DTensor
        parameters: {"loss", "gnorm", "lr"}, float32 0-d tensors (each
        rank's own, equal on every rank). Nothing is updated."""
        model = self.model
        model.zero_grad(set_to_none=True)
        batch = self.shard_batch(batch)
        self.dp = self.data_parallel(batch)
        local = {k: v.to_local() for k, v in batch.items()}
        with data_parallel(self.dp), tensor_parallel(self.tp), mesh_context(self.mesh, self.rules):
            loss = model.loss(local)
            loss.backward()
        if self.pod_group is not None:
            self._compress_pods_()
        gnorm = self._global_norm(self._grads())
        lr = lr_schedule(step, self.opt_cfg.lr, total=self.total_steps, device=loss.device)
        return {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}

    def _block(self, g):
        """The local block of a DTensor gradient; one sharded over 'pod' has
        no JAX counterpart (the JAX step's gradient is whole) and raises."""
        if not dict(zip(self.mesh.mesh_dim_names, g.placements))["pod"].is_replicate():
            raise ValueError(f"compress_pods: a gradient placed {g.placements} on "
                             f"{self.mesh.mesh_dim_names}; it must be replicated over 'pod'")
        return g.to_local()

    def _leaf_max(self, m: torch.Tensor) -> torch.Tensor:
        # over every rank of the mesh: a rank holding a replica adds nothing
        return DataParallel(self.mesh, self.mesh.mesh_dim_names).all_reduce(m, "max")

    def _global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every leaf, each rank summing its
        blocks (a block replicated over n ranks weighted 1/n), then one sum
        over the mesh."""
        sizes = axis_sizes(self.mesh)
        total = None
        for g in tree_leaves(grads):
            rep = math.prod(sizes[n] for n, pl in zip(self.mesh.mesh_dim_names, g.placements)
                            if pl.is_replicate())
            s = torch.sum(torch.square(g.to_local().float())) / rep
            total = s if total is None else total + s
        return torch.sqrt(DataParallel(self.mesh, self.mesh.mesh_dim_names).all_reduce(total))

    # ---------------- the state and the update ----------------
    def init_state(self) -> dict:
        """``adamw_init``'s state under the ZeRO shardings: DTensors, each
        rank allocating its blocks alone (8-bit scales, replicated, whole)."""
        from torch.distributed.tensor import zeros as dzeros
        cfg = self.opt_cfg

        def leaf(p, sh):
            base = sh["m_q" if cfg.state_bits == 8 else "m"]
            shape = tuple(p.shape)
            if cfg.state_bits == 8:
                n = shape[-1] if shape else 1
                rows, nb = math.prod(shape[:-1]) if shape else 1, max(1, -(-n // 128))
                q = dzeros(shape, dtype=torch.int8, device_mesh=self.mesh,
                           placements=base.placements)
                out = {"m_q": q, "v_q": q.clone(),
                       # the scales of a zero leaf: 0 / 127 + 1e-12
                       "m_s": distribute(torch.full((rows, nb), 1e-12, device=p.device),
                                         sh["m_s"])}
                out["v_s"] = out["m_s"].clone()
            else:
                out = {k: dzeros(shape, dtype=torch.float32, device_mesh=self.mesh,
                                 placements=base.placements) for k in ("m", "v")}
            if cfg.master_weights:
                out["master"] = _reshard(p.detach().float(), sh["master"].placements)
            return out

        params = self.model.tree()
        mu = _tree_pairs(params, self.opt_shardings["mu"], leaf)
        first = tree_leaves(params)[0]
        count = distribute(torch.zeros((), dtype=torch.int32, device=first.device),
                           self.opt_shardings["count"])
        return {"mu": mu, "count": count}

    def apply(self, opt_state: dict, metrics: dict) -> None:
        """The AdamW update of the step that gave ``metrics``: each rank's
        blocks of the state and its parameters', in place."""
        from torch.distributed.tensor import DTensor
        cfg = self.opt_cfg
        ps, gs = tree_leaves(self.model.tree()), tree_leaves(self._grads())
        mus = _state_leaves(opt_state["mu"])
        shs = _state_leaves(self.opt_shardings["mu"])
        psh = tree_leaves(self.param_shardings)
        count = opt_state["count"].to_local() + 1
        gnorm, lr = metrics["gnorm"], metrics["lr"]
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        c1 = 1 - cfg.b1 ** count.float()
        c2 = 1 - cfg.b2 ** count.float()

        def put(p, base, placements):            # base: the new weights' block
            new = DTensor.from_local(base, self.mesh, placements, shape=p.shape,
                                     stride=p.stride())
            p.to_local().copy_(_reshard(new, p.placements).to_local())

        with torch.no_grad():
            if cfg.state_bits == 8:
                for p, g, mu, sh, ps_ in zip(ps, gs, mus, shs, psh):
                    gf = g.full_tensor()
                    m = _dequantize(mu["m_q"].full_tensor(), mu["m_s"].to_local(), gf.shape)
                    v = torch.square(_dequantize(mu["v_q"].full_tensor(), mu["v_s"].to_local(),
                                                 gf.shape, floor=True))
                    base = (mu["master"].full_tensor() if cfg.master_weights
                            else p.full_tensor().float())
                    _adam_([gf.float()], [m], [v], [base], clip, c1, c2, lr, cfg)
                    for name, t in zip(("m_q", "m_s", "v_q", "v_s"),
                                       _quantize(m) + _quantize(torch.sqrt(v))):
                        mu[name].to_local().copy_(distribute(t, sh[name]).to_local())
                    if cfg.master_weights:
                        mu["master"].to_local().copy_(distribute(base, sh["master"]).to_local())
                    p.to_local().copy_(distribute(base.to(p.dtype), ps_).to_local())
            else:
                for idx in _groups([p.to_local().numel() for p in ps]):
                    pls = [shs[i]["m"].placements for i in idx]
                    bases = [mus[i]["master"].to_local() if cfg.master_weights
                             else _reshard(ps[i].detach(), pl).to_local().to(torch.float32,
                                                                             copy=True)
                             for i, pl in zip(idx, pls)]
                    _adam_([_reshard(gs[i], pl).to_local().float() for i, pl in zip(idx, pls)],
                           [mus[i]["m"].to_local() for i in idx],
                           [mus[i]["v"].to_local() for i in idx], bases, clip, c1, c2, lr, cfg)
                    for i, base, pl in zip(idx, bases, pls):
                        put(ps[i], base.to(ps[i].dtype), pl)
            opt_state["count"].to_local().copy_(count)
        self.model.zero_grad(set_to_none=True)


def jit_train_step(model, mesh, rules: ShardingRules = DEFAULT_RULES,
                   opt_cfg: OptConfig = OptConfig(), total_steps: int = 10_000,
                   compress_pods: bool = False):
    """The JAX entry point's counterpart: (step, (param_shardings,
    opt_shardings, the model's tree, its Axes tree)). On a mesh of more
    than one device the step is a ``ShardedTrainStep`` and the shardings
    are over the port's per-unit leaves (what the step, ``init_state`` and a
    checkpoint's restore place); on one device (or ``mesh=None``) it is
    ``TrainStep`` and the shardings are None. ``compress_pods``: the
    gradient through the int8 mean over 'pod' (module docstring)."""
    if mesh is None or math.prod(axis_sizes(mesh).values()) == 1:
        step = TrainStep(model, opt_cfg, total_steps, mesh, compress_pods)
        return step, (None, None, model.tree(), model_axes(model))
    step = ShardedTrainStep(model, mesh, rules, opt_cfg, total_steps, compress_pods)
    return step, (step.param_shardings, step.opt_shardings, model.tree(), model_axes(model))
