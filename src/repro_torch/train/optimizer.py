"""AdamW with optional 8-bit state (block-quantised), in torch.

The counterpart of ``repro.train.optimizer``, arithmetic for arithmetic (no
``torch.optim``: it rounds otherwise and has no 8-bit state): the global-norm
clip ``min(1, clip / (gnorm + 1e-9))``, bias corrections in float32,
``upd = (m / c1) / (sqrt(v / c2) + eps)``, decoupled decay
``base - lr * (upd + wd * base)``, optional float32 master weights, and the
8-bit state (``state_bits=8``): m and v as int8 with per-block float32 scales
(blocks of 128 along the last dim), v stored in sqrt space and dequantised
with a floor, so a tiny v never dequantises to 0.

A tree is a nested dict (or list) of tensors: the port's ``Model.tree()``,
whose ``units`` is a list of per-unit trees. The state is
``{"mu": <the params' tree, each leaf a dict of its moments>, "count": int32}``
(``models.convert.jax_layout`` stacks it as the JAX package's). The update
runs in place (``adamw_apply_``) over groups of leaves with ``torch._foreach``
ops, each op the JAX expression's, in its order; ``adamw_update`` is the JAX
signature's functional form.

ZeRO-1 (``zero_axes``, ``opt_state_shardings``): the state's shardings are
the parameters' with an extra ('data','pod') assignment on the first
still-replicated, dividing dimension, the JAX package's rule. On the JAX
layout's stacked leaves (``shapes_and_axes``) that dimension may be the
unit stack G; the port keeps units as a list, so its sharded step applies
the rule to each unit's own leaf, which then takes the extra sharding on
its first replicated, dividing dimension instead, or none. Where the two
differ (rwkv6-3b on both production meshes, qwen2-vl-72b on the single
pod), the per-device bytes are still equal: the train_4k dry run's
argument bytes in the JAX layout and the port's are rwkv6-3b 558324616
(single pod) and 481998792 (multi-pod), qwen2-vl-72b 7715639816 (single
pod) (``launch.dryrun``'s ``argument_bytes`` and ``argument_bytes_port``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Axes, ShardingRules, _tree_pairs, axis_sizes,
                                              logical_to_physical, named_sharding)

BLOCK = 128
# leaves updated together by one _foreach op each: a group holds up to this many
# elements (or one larger leaf), which bounds the update's transient tensors
GROUP = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 | 8
    master_weights: bool = False  # float32 master copies in the state


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list, dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def _state_leaves(mu) -> list:
    """The per-parameter state dicts of ``mu``, in ``tree_leaves`` order."""
    if isinstance(mu, dict) and not any(isinstance(v, (dict, list)) for v in mu.values()):
        return [mu]
    if isinstance(mu, dict):
        return [x for k in sorted(mu) for x in _state_leaves(mu[k])]
    return [x for t in mu for x in _state_leaves(t)]


# ---------------------------------------------------------------------------
# 8-bit block quantisation
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor):
    """float -> (int8, scales). Blocks along the last dim (padded)."""
    shape = x.shape
    n = shape[-1] if shape else 1
    nb = max(1, -(-n // BLOCK))
    pad = nb * BLOCK - n
    xp = F.pad(x.reshape(-1, n), (0, pad))
    xb = xp.reshape(-1, nb, BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return (q.reshape(-1, nb * BLOCK)[:, :n].reshape(shape),
            scale[..., 0].reshape(x.reshape(-1, n).shape[0], nb))


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, floor: bool = False):
    """int8 blocks -> float. ``floor=True`` clamps magnitudes below half an
    ULP up to scale/2 — used for the sqrt-second-moment so a tiny v can
    never dequantise to 0 and explode the Adam step (the error direction is
    then always a *smaller* step, never a larger one)."""
    n = shape[-1] if shape else 1
    nb = scale.shape[-1]
    pad = nb * BLOCK - n
    qp = F.pad(q.reshape(-1, n).float(), (0, pad))
    xb = qp.reshape(-1, nb, BLOCK)
    if floor:
        xb = torch.clamp(xb.abs(), min=0.5)
    x = xb * scale[..., None]
    return x.reshape(-1, nb * BLOCK)[:, :n].reshape(shape)


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments for every leaf of ``params`` (on its device), and count 0."""
    def leaf(p):
        p = p.detach()
        if cfg.state_bits == 8:
            q, s = _quantize(torch.zeros_like(p, dtype=torch.float32))
            out = {"m_q": q, "m_s": s, "v_q": q.clone(), "v_s": s.clone()}
        else:
            out = {"m": torch.zeros_like(p, dtype=torch.float32),
                   "v": torch.zeros_like(p, dtype=torch.float32)}
        if cfg.master_weights:
            out["master"] = p.float().clone()
        return out
    first = tree_leaves(params)[0]
    return {"mu": tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares, in
    float32, as the JAX package sums it. (``torch.sum`` adds pairwise; the
    CPU's ``vector_norm`` and ``_foreach_norm`` add in order and lose 1e-5 of
    the norm at 2^20 elements, 2e-2 at the 155M of qwen3-0.6b's embedding.)"""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def _groups(n_elems: list) -> list:
    """Index lists of consecutive leaves of up to GROUP elements each."""
    out, cur, size = [], [], 0
    for i, n in enumerate(n_elems):
        if cur and size + n > GROUP:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return out + [cur] if cur else out


def _adam_(gs, ms, vs, bases, clip, c1, c2, lr, cfg: OptConfig) -> None:
    """The AdamW arithmetic over lists of float32 tensors, in place: ``gs``
    (raw grads, left as they are), ``ms`` and ``vs`` take the new moments,
    ``bases`` the new weights. Each op is one of the JAX expression's."""
    gs = torch._foreach_mul(gs, clip)                    # g * clip
    torch._foreach_mul_(ms, cfg.b1)                      # m = b1*m + (1-b1)*g
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - cfg.b1))
    g2 = torch._foreach_mul(gs, 1 - cfg.b2)              # v = b2*v + (1-b2)*g*g
    torch._foreach_mul_(g2, gs)
    del gs
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_add_(vs, g2)
    den = torch._foreach_div(vs, c2)                     # sqrt(v/c2) + eps
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(ms, c1)                     # (m/c1) / den
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(bases, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)                         # base - lr*(upd + wd*base)
    torch._foreach_sub_(bases, upd)


def adamw_apply_(params, grads, state: dict, lr, gnorm, cfg: OptConfig) -> None:
    """One AdamW step in place: ``params`` (a tree) take their new values,
    ``state`` its new moments and count. ``gnorm`` is ``global_norm`` of
    ``grads`` (a tree of the params' shape); ``lr`` a float or a float32
    0-d tensor."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    mus = _state_leaves(state["mu"])
    count = state["count"] + 1
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c1 = 1 - cfg.b1 ** count.float()
    c2 = 1 - cfg.b2 ** count.float()
    with torch.no_grad():
        if cfg.state_bits == 8:
            for p, g, mu in zip(ps, gs, mus):
                m = _dequantize(mu["m_q"], mu["m_s"], g.shape)
                # v rides in sqrt-space: floored dequant => the denominator
                # can never hit zero
                v = torch.square(_dequantize(mu["v_q"], mu["v_s"], g.shape, floor=True))
                base = mu["master"] if cfg.master_weights else p.float()
                _adam_([g.float()], [m], [v], [base], clip, c1, c2, lr, cfg)
                for name, t in zip(("m_q", "m_s", "v_q", "v_s"),
                                   _quantize(m) + _quantize(torch.sqrt(v))):
                    mu[name].copy_(t)
                if base is not p:
                    p.copy_(base)
        else:
            for idx in _groups([p.numel() for p in ps]):
                bases = [mus[i]["master"] if cfg.master_weights else ps[i].float() for i in idx]
                _adam_([gs[i].float() for i in idx], [mus[i]["m"] for i in idx],
                       [mus[i]["v"] for i in idx], bases, clip, c1, c2, lr, cfg)
                for i, base in zip(idx, bases):
                    if base is not ps[i]:
                        ps[i].copy_(base)
        state["count"].copy_(count)


def adamw_update(grads, state: dict, params, lr, cfg: OptConfig):
    """The JAX signature: (new params, new state, gnorm), the inputs left as
    they are."""
    params = tree_map(lambda p: p.detach().clone(), params)
    state = tree_map(lambda t: t.clone(), state)
    gnorm = global_norm(tree_leaves(grads))
    adamw_apply_(params, grads, state, lr, gnorm, cfg)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# ZeRO-1 sharding for the state
# ---------------------------------------------------------------------------

def zero_axes(axes: Axes, shape, mesh, rules: ShardingRules) -> Axes:
    """Param logical axes -> state logical axes with ZeRO 'opt' on the first
    dim that resolves to replicated and divides the opt axes product."""
    spec = logical_to_physical(axes, mesh, rules, shape)
    sizes = axis_sizes(mesh)
    opt_axes = rules.get("opt") or ()
    opt_size = 1
    for a in opt_axes:
        opt_size *= sizes.get(a, 1)
    out = list(axes)
    for d, (name, resolved) in enumerate(zip(axes, tuple(spec) + (None,) * 9)):
        if resolved is None and shape[d] % max(opt_size, 1) == 0 and opt_size > 1:
            out[d] = "opt"
            break
    return Axes(*out)


def opt_state_shardings(params_shapes, param_axes, mesh, rules: ShardingRules,
                        cfg: OptConfig):
    """NamedSharding tree matching ``adamw_init``'s structure, for a tree of
    parameters (tensors, ``meta`` ones will do) and its Axes tree: the JAX
    layout's (``shapes_and_axes``) or the port's (units as lists)."""
    def one(t, axes):
        shape = tuple(t.shape)
        base = named_sharding(zero_axes(axes, shape, mesh, rules), mesh, rules, shape)
        if cfg.state_bits == 8:
            # scales are 2D (rows, blocks): replicated (small)
            rep = named_sharding(Axes(None, None), mesh, rules)
            out = {"m_q": base, "m_s": rep, "v_q": base, "v_s": rep}
        else:
            out = {"m": base, "v": base}
        if cfg.master_weights:
            out["master"] = base
        return out

    return {"mu": _tree_pairs(params_shapes, param_axes, one),
            "count": named_sharding(Axes(), mesh, rules)}
