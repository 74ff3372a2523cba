"""Mixture-of-Experts with three dispatch paths, in torch.

The counterpart of ``repro.models.moe``. ``dispatch='einsum'``: capacity-
based one-hot dispatch and combine einsums. ``dispatch='sort'``: the
(token, expert) assignment list sorted by expert key once (a stable sort),
each expert's tokens a contiguous slice, scattered back. ``dispatch=
'gsort'``: the same sort within token groups. All three are capacity-bounded
(tokens above an expert's capacity drop to the residual stream, the same
tokens in every path) and return the load-balancing auxiliary loss beside
the output, as the JAX functions return it.

Under the sharded train step (``distributed.sharding.current_dp()``), each
data-parallel rank routes its own block of the tokens, and the router's
balance statistics, the capacity and each assignment's rank within its
expert are the whole batch's: the statistics are summed over the ranks, and
the ranks of earlier blocks' assignments offset this block's. So the same
tokens drop as on one device. Each rank's expert buffer holds only its own
tokens' slots (at most min(C, its tokens) an expert).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import TPParams, Axes, constrain, current_dp, current_tp
from .layers import ParamBuilder


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert intermediate
    num_shared: int = 0            # shared (always-on) experts, deepseek-v2
    shared_d_ff: int | None = None
    capacity_factor: float = 1.25
    dispatch: str = "einsum"       # 'einsum' | 'sort' | 'gsort'
    num_groups: int = 32           # gsort dispatch: token groups
    router_zloss: float = 1e-3
    aux_loss: float = 1e-2


def moe_init(gen, d_model: int, cfg: MoEConfig):
    b = ParamBuilder(gen)
    E, F_ = cfg.num_experts, cfg.d_ff
    b.w("router", (d_model, E), Axes("embed", "experts"), fan_in=d_model)
    b.w("w_gate", (E, d_model, F_), Axes("experts", "embed", "d_ff"), fan_in=d_model)
    b.w("w_up", (E, d_model, F_), Axes("experts", "embed", "d_ff"), fan_in=d_model)
    b.w("w_down", (E, F_, d_model), Axes("experts", "d_ff", "embed"), fan_in=F_)
    if cfg.num_shared:
        sf = cfg.shared_d_ff or cfg.d_ff * cfg.num_shared
        b.w("sh_gate", (d_model, sf), Axes("embed", "d_ff"), fan_in=d_model)
        b.w("sh_up", (d_model, sf), Axes("embed", "d_ff"), fan_in=d_model)
        b.w("sh_down", (sf, d_model), Axes("d_ff", "embed"), fan_in=sf)
    return b.build()


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, x, cfg: MoEConfig):
    """x: (T, D) -> (gates (T,k), idx (T,k), aux_loss)."""
    logits = torch.einsum("td,de->te", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load balance: mean prob * mean assignment per expert
    T = x.shape[0]
    dp = current_dp()
    if dp is None:
        me = probs.mean(0)
        ce = probs.new_zeros(cfg.num_experts).index_add_(
            0, idx.reshape(-1), probs.new_full((idx.numel(),), 1.0 / (T * cfg.top_k)))
        zloss = cfg.router_zloss * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    else:                                      # the whole batch's statistics
        Tg = T * dp.size
        me = dp.sum(probs.sum(0)) / Tg
        counts = probs.new_zeros(cfg.num_experts).index_add_(
            0, idx.reshape(-1), probs.new_ones(idx.numel()))
        ce = dp.all_reduce(counts) / (Tg * cfg.top_k)
        zloss = cfg.router_zloss * dp.sum(torch.sum(torch.logsumexp(logits, dim=-1) ** 2)) / Tg
    aux = cfg.aux_loss * cfg.num_experts * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux + zloss


def _expert_ffn(params, h, act=F.silu):
    """h: (E, C, D) -> (E, C, D), batched over the expert dim."""
    g = torch.einsum("ecd,edf->ecf", h, params["w_gate"].to(h.dtype))
    u = torch.einsum("ecd,edf->ecf", h, params["w_up"].to(h.dtype))
    z = constrain(act(g) * u, "experts", None, "d_ff")
    return torch.einsum("ecf,efd->ecd", z, params["w_down"].to(h.dtype))


def _capacity(T: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * T * cfg.top_k / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _block_offsets(dp, keys, E: int):
    """Each expert's assignments in the data-parallel blocks before this
    rank's (E,), for the whole batch's capacity ranks."""
    keys = keys.reshape(-1)
    counts = keys.new_zeros(E).index_add_(0, keys, torch.ones_like(keys))
    return dp.gather(counts)[:dp.rank].sum(0)


def _tp_experts(params, x, gates, cfg: MoEConfig):
    """(x, gates, first expert, expert count, tp): under tensor parallelism
    (``TPParams``), the experts this rank holds (all of them, each its share
    of d_ff, where the experts do not split), with x and the gates entering
    the split; else every expert."""
    tp = current_tp() if isinstance(params, TPParams) else None
    if tp is None:
        return x, gates, 0, cfg.num_experts, None
    El = params["w_up"].shape[0]
    lo = tp.rank * El if El < cfg.num_experts else 0
    return tp.enter(x), tp.enter(gates), lo, El, tp


def _moe_einsum(params, x, cfg: MoEConfig):
    T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dp = current_dp()
    C = _capacity(T if dp is None else T * dp.size, cfg)
    gates, idx, aux = _router(params, x, cfg)
    # position of each (t, k) assignment within its expert's capacity
    onehot = F.one_hot(idx, E)                             # (T,k,E)
    csum = torch.cumsum(onehot.reshape(T * K, E), dim=0)
    Cl, off = C, 0
    if dp is not None:                   # ranks in the whole batch; local slots
        off = _block_offsets(dp, idx, E)
        Cl = min(C, T)                   # a token picks an expert at most once
    pos = (csum + off).reshape(T, K, E) * onehot - 1
    within_cap = (pos >= 0) & (pos < C)
    pos = pos - off
    # a position past C is masked by within_cap (jax.nn.one_hot gives it a
    # zero row; F.one_hot wants it in range)
    disp = (F.one_hot(pos.clamp(0, Cl - 1), Cl).to(x.dtype)
            * within_cap[..., None].to(x.dtype)
            * onehot[..., None].to(x.dtype))              # (T,k,E,C)
    x, gates, lo, El, tp = _tp_experts(params, x, gates, cfg)
    if tp is not None:
        disp = disp[:, :, lo:lo + El]
    h = torch.einsum("td,tec->ecd", x, disp.sum(1))
    h = constrain(h, "experts", None, "embed")
    out_e = _expert_ffn(params, h)
    comb = torch.einsum("tkec,tk->tec", disp, gates)
    y = torch.einsum("ecd,tec->td", out_e, comb)
    return y, aux


def _moe_sort(params, x, cfg: MoEConfig):
    """Global stream dispatch: the (expert, token) key stream sorted once
    (stable), each assignment ranked within its expert by ``searchsorted``."""
    T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dp = current_dp()
    C = _capacity(T if dp is None else T * dp.size, cfg)
    gates, idx, aux = _router(params, x, cfg)
    flat_e = idx.reshape(-1)                               # (T*K,) expert keys
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)             # stream sort
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    ranks = torch.arange(T * K, device=x.device)
    first = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos = ranks - first[se]
    Cl = C
    if dp is None:
        keep = pos < C
    else:                                # ranks in the whole batch; local slots
        keep = pos + _block_offsets(dp, idx, E)[se] < C
        Cl = min(C, T)                   # a token picks an expert at most once
    x, sg, lo, E, tp = _tp_experts(params, x, sg, cfg)
    if tp is not None:                   # this rank's experts' assignments
        keep = keep & (se >= lo) & (se < lo + E)
        se = se - lo
    # a dropped assignment writes to the spare row E, cut off (no
    # data-dependent shape: the dry run traces this under fake tensors)
    h = x.new_zeros((E + 1, Cl, D))
    h[torch.where(keep, se, E), torch.where(keep, pos, 0)] = x[st]
    h = constrain(h[:E], "experts", None, "embed")
    out_e = _expert_ffn(params, h)
    contrib = out_e[torch.where(keep, se, 0), torch.where(keep, pos, 0)]
    contrib = contrib * (sg * keep)[:, None]
    y = x.new_zeros((T, D)).index_add_(0, st, contrib)
    return y, aux


def _moe_gsort(params, x, cfg: MoEConfig):
    """Group-local stream dispatch: the key stream sorted within each of
    ``num_groups`` token groups (one group when T does not divide), each
    group's tokens scattered into its own (E, C_g) capacity slots. Under
    data parallelism each rank holds whole groups of the batch, so it
    sorts its own."""
    T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dp = current_dp()
    G = cfg.num_groups if T % cfg.num_groups == 0 else 1
    if dp is not None:
        G = cfg.num_groups if (T * dp.size) % cfg.num_groups == 0 else 1
        if G % dp.size:
            raise NotImplementedError(
                f"gsort dispatch under {dp.size}-way data parallelism needs the "
                f"{G} token groups to split evenly over the ranks")
        G //= dp.size
    Tg = T // G
    Cg = max(8, -(-int(cfg.capacity_factor * Tg * K / E) // 8) * 8)
    gates, idx, aux = _router(params, x, cfg)
    dev = x.device

    eg = idx.reshape(G, Tg * K)                            # per-group keys
    gg = gates.reshape(G, Tg * K)
    order = torch.argsort(eg, dim=1, stable=True)          # local stream sort
    se = torch.gather(eg, 1, order)                        # (G, TgK) sorted
    st = order // K                                        # token within group
    sg = torch.gather(gg, 1, order)
    ranks = torch.arange(Tg * K, device=dev)[None, :]
    first = torch.searchsorted(se, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = ranks - torch.gather(first, 1, se)
    keep = pos < Cg
    x, sg, lo, E, tp = _tp_experts(params, x, sg, cfg)
    if tp is not None:                   # this rank's experts' assignments
        keep = keep & (se >= lo) & (se < lo + E)
        se = se - lo
    grp = torch.arange(G, device=dev)[:, None].expand(G, Tg * K)
    gathered = torch.gather(x.reshape(G, Tg, D), 1, st[..., None].expand(G, Tg * K, D))
    h = x.new_zeros((G, E + 1, Cg, D))                     # dropped: the spare row E
    h[grp, torch.where(keep, se, E), torch.where(keep, pos, 0)] = gathered
    h = constrain(h[:, :E], "moe_groups", "experts", None, "embed")
    # the group -> expert transpose (the all-to-all boundary when sharded)
    ht = constrain(h.transpose(0, 1).reshape(E, G * Cg, D), "experts", "moe_cap", "embed")
    out_e = _expert_ffn(params, ht)
    back = out_e.reshape(E, G, Cg, D).transpose(0, 1)
    back = constrain(back, "moe_groups", "experts", None, "embed")
    contrib = back[grp, torch.where(keep, se, 0), torch.where(keep, pos, 0)]
    contrib = contrib * (sg * keep)[..., None]             # (G, TgK, D)
    y = x.new_zeros((T, D)).index_add_(0, (grp * Tg + st).reshape(-1), contrib.reshape(-1, D))
    return y, aux


def moe_apply(params, x, cfg: MoEConfig):
    """x: (B, S, D) -> (y, aux_loss)."""
    B, S, D = x.shape
    flat = x.reshape(B * S, D)
    if cfg.dispatch == "sort":
        y, aux = _moe_sort(params, flat, cfg)
    elif cfg.dispatch == "gsort":
        y, aux = _moe_gsort(params, flat, cfg)
    else:
        y, aux = _moe_einsum(params, flat, cfg)
    tp = current_tp() if isinstance(params, TPParams) else None
    if cfg.num_shared:
        xs = flat if tp is None else tp.enter(flat)
        g = torch.einsum("td,df->tf", xs, params["sh_gate"].to(x.dtype))
        u = torch.einsum("td,df->tf", xs, params["sh_up"].to(x.dtype))
        ys = torch.einsum("tf,fd->td", F.silu(g) * u, params["sh_down"].to(x.dtype))
        if tp is not None and params["sh_up"].shape[-1] == (cfg.shared_d_ff
                                                             or cfg.d_ff * cfg.num_shared):
            ys = ys * (tp.rank == 0)     # a d_ff that does not split: one rank's
        y = y + ys
    if tp is not None:                   # the sum of the ranks' experts
        y = tp.leave(y)
    return y.reshape(B, S, D), aux
