"""One model covering the ten architectures, in torch.

The counterpart of ``repro.models.transformer``: one decoder (or
encoder-decoder) skeleton specialised by ``ModelConfig``: layer pattern units
(jamba's (m,m,m,a,m,m,m,m)) with heterogeneous kinds (attn/mamba/rwkv),
per-position sliding windows (gemma2 local/global), MoE periods (jamba every
other layer, deepseek all but the first), shared experts, MLA, qk-norm,
softcaps, M-RoPE, KV-head replication, and encoder-decoder wiring
(seamless-m4t).

``Model`` is an ``nn.Module`` whose parameters carry the JAX tree's leaf
names: ``embed``, ``units.<g>.l0.attn.wq``, ``dense0.ffn.w_up``, ... The
JAX package stacks the ``num_units`` repeats of the unit on a leading axis
G and scans over it; the port holds them in ``units``, an ``nn.ModuleList``,
and loops (``models.convert`` carries a JAX parameter tree across).
Parameters are float32 and cast to ``cfg.dtype`` at each use.

Sharding: ``constrain`` stands at the JAX package's 19 activation
constraints (a no-op with no mesh context). The sharded train step
(``train.train_step.ShardedTrainStep``) keeps the parameters as DTensors
and sets ``Model.gather``: every read of a parameter goes through it
(``_t``, ``_tree_of``), so a unit's parameters are gathered whole inside its
checkpointed call and again in its recompute, one unit at a time; under
``current_dp()`` the loss's sums and counts are the whole batch's.

Training: ``Model.loss`` is the chunked cross-entropy (the (B, S, V)
logits never exist; each chunk is checkpointed), and ``cfg.remat`` sets
what the backward pass recomputes of each unit and encoder layer, as the
JAX package's ``jax.checkpoint`` policies do.

Serving: attention layers hold (K, V) caches of the unrepeated KV heads
(MLA layers the compressed c_kv and k_rope); mamba and rwkv layers hold
O(1) recurrent state in float32. Caches are a dict of tensors shaped as
the JAX package's, the leading G axis included; ``decode_step`` writes them
in place and returns them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import TPParams, Axes, constrain, current_dp, current_tp
from . import layers as L
from .layers import META, AttnConfig, MLAConfig, ParamBuilder, apply_rope
from .mamba import MambaConfig, mamba_apply, mamba_decode, mamba_init
from .moe import MoEConfig, moe_apply, moe_init
from .rwkv import (RWKVConfig, rwkv_apply, rwkv_channel_apply, rwkv_channel_init,
                   rwkv_decode, rwkv_init)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # layer pattern: repeating unit of kinds; len must divide covered layers
    pattern: tuple[str, ...] = ("attn",)
    # attention flavour
    attention: str = "gqa"                 # 'gqa' | 'mla'
    qk_norm: bool = False
    softcap: float | None = None
    # per-position-in-unit sliding windows (None = global); len == len(pattern)
    windows: tuple | None = None
    use_rope: bool = True
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None
    kv_repeat: int = 1                     # replicate KV heads in the forward
    # MoE
    moe: MoEConfig | None = None
    moe_period: int = 1                    # MoE every Nth layer
    first_dense: int = 0                   # leading dense layers (deepseek)
    first_dense_ff: int | None = None
    # alternative blocks
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    # encoder-decoder (seamless): encoder shares d_model/heads
    encoder_layers: int = 0
    frontend: str | None = None            # 'audio' | 'vision' stub marker
    # numerics / runtime
    norm: str = "rmsnorm"                  # 'rmsnorm' | 'layernorm'
    gated_mlp: bool = True                 # False: classic 2-matrix FFN
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    remat: str = "minimal"                 # training: 'none' | 'minimal' | 'dots'
    blocked_threshold: int = 8192
    block_k: int = 1024
    logit_softcap: float | None = None     # gemma2 final softcap
    loss_chunk: int = 512                  # chunked cross-entropy: the (B,S,V)
    #                                        logits tensor is never
    #                                        materialised (see Model.loss)
    unroll_units: bool = False             # the JAX package's roofline knob; unused here

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_cfg(self, window=None) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.hd,
            qk_norm=self.qk_norm, softcap=self.softcap, window=window,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections,
            block_k=self.block_k, blocked_threshold=self.blocked_threshold)

    @property
    def unit(self) -> tuple[str, ...]:
        return self.pattern

    @property
    def num_units(self) -> int:
        n = self.num_layers - self.first_dense
        if n % len(self.unit):
            raise ValueError(f"{self.name}: {n} layers not divisible by unit {self.unit}")
        return n // len(self.unit)

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.moe is not None and layer_idx >= self.first_dense
                and (layer_idx - self.first_dense) % self.moe_period == 0)


# ---------------------------------------------------------------------------
# init: the JAX parameter tree, with units and encoder as lists of G trees
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, kind: str, layer_idx: int, cross: bool = False):
    b = ParamBuilder(gen)
    b.sub("norm1", *L.rmsnorm_init(gen, cfg.d_model))
    if kind == "attn":
        if cfg.attention == "mla":
            b.sub("attn", *L.mla_init(gen, cfg.mla))
        else:
            b.sub("attn", *L.gqa_init(gen, cfg.attn_cfg()))
    elif kind == "mamba":
        b.sub("mamba", *mamba_init(gen, cfg.mamba))
    elif kind == "rwkv":
        b.sub("rwkv", *rwkv_init(gen, cfg.rwkv))
    else:
        raise ValueError(kind)
    if cross:
        b.sub("norm_cross", *L.rmsnorm_init(gen, cfg.d_model))
        b.sub("cross", *L.gqa_init(gen, cfg.attn_cfg()))
    b.sub("norm2", *L.rmsnorm_init(gen, cfg.d_model))
    if kind == "rwkv":
        b.sub("ffn", *rwkv_channel_init(gen, cfg.rwkv))
    elif cfg.is_moe_layer(layer_idx):
        b.sub("ffn", *moe_init(gen, cfg.d_model, cfg.moe))
    else:
        b.sub("ffn", *L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp))
    return b.build()


def _units_init(gen, cfg: ModelConfig, num_units: int, unit_offset: int, cross: bool = False):
    """``num_units`` unit trees and the axes of one (no G axis)."""
    units, axes = [], None
    for _ in range(num_units):
        ps, axs = {}, {}
        for i, kind in enumerate(cfg.unit):
            ps[f"l{i}"], axs[f"l{i}"] = _layer_init(gen, cfg, kind, unit_offset + i, cross=cross)
        units.append(ps)
        axes = axs
    return units, axes


def init_params(cfg: ModelConfig, gen: torch.Generator | None):
    """(params, axes): the JAX ``Model.init`` tree, but ``units`` and
    ``encoder`` are lists of per-unit trees and their axes have no G axis.
    ``gen=None`` builds every leaf on the ``meta`` device."""
    b = ParamBuilder(gen)
    b.w("embed", (cfg.vocab_size, cfg.d_model), Axes("vocab", "embed"), fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        b.w("unembed", (cfg.d_model, cfg.vocab_size), Axes("embed", "vocab"),
            fan_in=cfg.d_model)
    if cfg.first_dense:
        dense_cfg = dataclasses.replace(cfg, moe=None, d_ff=cfg.first_dense_ff or cfg.d_ff)
        for i in range(cfg.first_dense):
            b.sub(f"dense{i}", *_layer_init(gen, dense_cfg, "attn", i))
    b.sub("units", *_units_init(gen, cfg, cfg.num_units, cfg.first_dense,
                                cross=bool(cfg.encoder_layers)))
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, moe=None, pattern=("attn",), windows=None)
        b.sub("encoder", *_units_init(gen, enc_cfg, cfg.encoder_layers, 0))
        b.sub("enc_norm", *L.rmsnorm_init(gen, cfg.d_model))
    b.sub("final_norm", *L.rmsnorm_init(gen, cfg.d_model))
    return b.build()


STACKED = ("units", "encoder")


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tp_splits(block: dict, tp) -> bool:
    """Whether a block of DTensor parameters runs tensor parallel under
    ``tp``: its heads (attention), its experts or their d_ff (MoE) or its
    d_ff (MLP) split over 'model'. RWKV's channel mix does not."""
    if "maa_k" in block:
        return False
    if "wq" in block:
        return tp.splits(block["wq"], 1) and tp.splits(block["wo"], 0)
    if "router" in block:
        return tp.splits(block["w_up"], 0) or tp.splits(block["w_up"], 2)
    return tp.splits(block["w_up"], 1) and tp.splits(block["w_down"], 0)


def _gather_tree(tree: dict, gather, tp) -> dict:
    """``tree``'s parameters through ``gather``; under ``tp``, each
    attention, cross-attention and FFN block that splits over 'model' as
    ``TPParams`` (the MoE router whole: routing stays outside the split)."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = gather(v)
        elif tp is not None and k in ("attn", "cross", "ffn") and _tp_splits(v, tp):
            out[k] = TPParams(_map_tree(lambda p: gather(p, tp=True),
                                        {n: w for n, w in v.items() if n != "router"}))
            if "router" in v:
                out[k]["router"] = gather(v["router"])
        else:
            out[k] = _gather_tree(v, gather, tp)
    return out


def _whole_kv(q, k, cfg) -> bool:
    """Whether ``q`` holds a tensor-parallel rank's share of the heads and
    ``k`` every kv head (their weights did not split over 'model')."""
    return q.shape[2] < cfg.num_heads and k.shape[2] == cfg.num_kv_heads * cfg.kv_repeat


def _local_kv(k, v, Hl: int, tp):
    """The key/value heads (whole, after ``kv_repeat``) that this rank's
    ``Hl`` query heads read: a contiguous run where they cover whole groups
    or lie in one, else one a query head."""
    g = Hl * tp.size // k.shape[2]              # query heads a kv head
    lo = tp.rank * Hl
    if Hl % g == 0 or g % Hl == 0:
        sl = slice(lo // g, lo // g + max(1, Hl // g))
        return k[:, :, sl], v[:, :, sl]
    idx = torch.div(torch.arange(lo, lo + Hl, device=k.device), g, rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: a dict a submodule, a tensor a
    parameter, under the dict's own keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the output of a matrix product with no batch dimension (``torch.einsum``
    contracts a weight as a ``bmm`` of batch 1), recompute everything else."""
    if op in _DOTS or (op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Model runs on a CUDA device by default and torch.cuda.is_available() "
            "is False; pass device='cpu' to run it on the CPU")
    return device


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """The model of ``cfg`` on ``device``, its weights drawn from ``generator``
    (a seeded CPU ``torch.Generator`` when None) and moved there; on
    ``device="meta"`` nothing is drawn or allocated."""

    def __init__(self, cfg: ModelConfig, device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = _check_device(device)
        self.cfg = cfg
        if device.type == "meta":
            gen = None
        else:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params, _ = init_params(cfg, gen)
        for k, v in params.items():
            if k in STACKED:
                self.add_module(k, nn.ModuleList(ParamTree(u) for u in v))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))
        self.to(device)
        self.gather = None     # set by the sharded step: parameter -> its whole value

    def _t(self, p):
        return p if self.gather is None else self.gather(p)

    def _tree_of(self, mod) -> dict:
        t = mod.tree()
        return t if self.gather is None else _gather_tree(t, self.gather, current_tp())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> dict:
        """The parameters as the JAX tree, ``units``/``encoder`` as lists."""
        out = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = [u.tree() for u in m] if k in STACKED else m.tree()
        return out

    # ---------------- shared pieces ----------------
    def _norm(self, p, x):
        if self.cfg.norm == "layernorm":
            dt = x.dtype
            xf = x.float()
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            return ((xf - mu) * torch.rsqrt(var + self.cfg.norm_eps) * p["scale"]).to(dt)
        return L.rmsnorm(p, x, self.cfg.norm_eps)

    def _vocab_tp(self, p, dim: int):
        """``current_tp()`` when the vocabulary dimension ``dim`` of the
        sharded parameter ``p`` splits over 'model', else None."""
        tp = current_tp()
        return tp if tp is not None and self.gather is not None and tp.splits(p, dim) else None

    def _embed(self, tokens):
        tp = self._vocab_tp(self.embed, 0)
        if tp is not None:           # this rank's rows, zero elsewhere, summed over the ranks
            table = self.gather(self.embed, tp=True)
            i = tokens - tp.rank * table.shape[0]
            mine = (i >= 0) & (i < table.shape[0])
            rows = tp.leave(table[torch.where(mine, i, 0)] * mine[..., None])
            return rows.to(self.cfg.dtype) * math.sqrt(self.cfg.d_model)
        # the row gather before the cast: the same values as casting the table
        return self._t(self.embed)[tokens].to(self.cfg.dtype) * math.sqrt(self.cfg.d_model)

    def _unembed(self):
        return (self._t(self.embed).to(self.cfg.dtype).T if self.cfg.tie_embeddings
                else self._t(self.unembed).to(self.cfg.dtype))

    def _logits(self, x, w=None):
        w = self._unembed() if w is None else w
        logits = torch.einsum("bsd,dv->bsv", x, w).float()
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return constrain(logits, "batch", "seq", "vocab")

    def _window_for(self, pos_in_unit: int):
        return None if self.cfg.windows is None else self.cfg.windows[pos_in_unit]

    def _self_attn(self, p, h, positions, window, causal=True):
        cfg = self.cfg
        tp = current_tp() if isinstance(p, TPParams) else None
        if tp is not None:                 # this rank's heads; the sum of their outputs
            y, kv = self._self_attn(dict(p), tp.enter(h), positions, window, causal)
            return tp.leave(y), kv
        if cfg.attention == "mla":
            return L.mla_apply(p, h, positions, cfg.mla)
        acfg = cfg.attn_cfg(window)
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
        if acfg.qk_norm:
            q = L._qk_norm(q, p["q_norm"])
            k = L._qk_norm(k, p["k_norm"])
        if cfg.use_rope:
            q = apply_rope(q, positions, acfg.rope_theta, acfg.mrope_sections)
            k = apply_rope(k, positions, acfg.rope_theta, acfg.mrope_sections)
        if cfg.kv_repeat > 1:
            k = k.repeat_interleave(cfg.kv_repeat, dim=2)
            v = v.repeat_interleave(cfg.kv_repeat, dim=2)
        if _whole_kv(q, k, cfg):                # this rank's query heads read these
            k, v = _local_kv(k, v, q.shape[2], current_tp())
        pos2d = positions if positions.ndim == 2 else positions[0]
        out = L.attention(q, k, v, pos2d, pos2d, acfg, causal=causal)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(h.dtype)), (k, v)

    def _cross_attn(self, p, h, positions, enc_states, enc_pos):
        cfg = self.cfg
        tp = current_tp() if isinstance(p, TPParams) else None
        if tp is not None:
            return tp.leave(self._cross_attn(dict(p), tp.enter(h), positions,
                                             tp.enter(enc_states), enc_pos))
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
        k = torch.einsum("bsd,dhk->bshk", enc_states, p["wk"].to(h.dtype))
        v = torch.einsum("bsd,dhk->bshk", enc_states, p["wv"].to(h.dtype))
        if cfg.kv_repeat > 1:
            k = k.repeat_interleave(cfg.kv_repeat, dim=2)
            v = v.repeat_interleave(cfg.kv_repeat, dim=2)
        if _whole_kv(q, k, cfg):
            k, v = _local_kv(k, v, q.shape[2], current_tp())
        pos2d = positions if positions.ndim == 2 else positions[0]
        out = L.attention(q, k, v, pos2d, enc_pos, cfg.attn_cfg(), causal=False)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(h.dtype))

    def _ffn(self, p, h, aux):
        if "router" in p:
            y, a = moe_apply(p, h, self.cfg.moe)
            return y, aux + a
        if "maa_k" in p:                                   # rwkv channel mix, no x_prev
            return rwkv_channel_apply(p, h), aux
        if isinstance(p, TPParams):                        # this rank's d_ff
            tp = current_tp()
            return tp.leave(L.mlp_apply(p, tp.enter(h), self.cfg.act)), aux
        return L.mlp_apply(p, h, self.cfg.act), aux

    def _zero(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _remat(self, fn, *args):
        """``fn(*args)`` under ``cfg.remat`` when grad is enabled (the JAX
        package's ``_maybe_remat``): 'none' keeps every activation, 'dots'
        keeps the outputs of the weight products and recomputes the rest in
        the backward pass, any other value ('minimal') keeps only the inputs."""
        if self.cfg.remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if self.cfg.remat == "dots":
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=_dots_context)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    # ---------------- forward ----------------
    def _unit_fwd(self, up, x, positions, enc_states=None, enc_pos=None):
        cfg = self.cfg
        aux = self._zero()
        for i, kind in enumerate(cfg.unit):
            p = up[f"l{i}"]
            h = self._norm(p["norm1"], x)
            if kind == "attn":
                y, _ = self._self_attn(p["attn"], h, positions, self._window_for(i))
            elif kind == "mamba":
                y, _ = mamba_apply(p["mamba"], h, cfg.mamba)
            else:
                y, _ = rwkv_apply(p["rwkv"], h, cfg.rwkv)
            x = x + y
            if enc_states is not None:
                hc = self._norm(p["norm_cross"], x)
                x = x + self._cross_attn(p["cross"], hc, positions, enc_states, enc_pos)
            h = self._norm(p["norm2"], x)
            y, aux = self._ffn(p["ffn"], h, aux)
            x = x + y
            x = constrain(x, "batch", "seq", "embed")
        return x, aux

    def _enc_layer(self, unit, x, pos):
        p = self._tree_of(unit)["l0"]
        h = self._norm(p["norm1"], x)
        y, _ = self._self_attn(p["attn"], h, pos, None, causal=False)
        x = x + y
        h = self._norm(p["norm2"], x)
        y, _ = self._ffn(p["ffn"], h, self._zero())
        return constrain(x + y, "batch", "seq", "embed")

    def _encode(self, batch):
        """The encoder over ``batch["frames"]`` (B, Se, d): (states, positions)."""
        x = batch["frames"].to(self.device, self.cfg.dtype)
        B, Se, _ = x.shape
        pos = torch.arange(Se, dtype=torch.int32, device=self.device).expand(B, Se)
        for unit in self.encoder:
            x = self._remat(self._enc_layer, unit, x, pos)
        return self._norm(self._tree_of(self.enc_norm), x), pos

    def _positions(self, batch, tokens):
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        if self.cfg.mrope_sections is not None and "mrope_positions" in batch:
            positions = batch["mrope_positions"]
        return positions

    def apply(self, batch):
        """batch["tokens"] (B, S) -> (float32 logits (B, S, V), aux loss)."""
        x, aux = self.apply_hidden(batch)
        return self._logits(x), aux

    def _dense_layer_fwd(self, p, x, positions):
        h = self._norm(p["norm1"], x)
        y, _ = self._self_attn(p["attn"], h, positions, None)
        x = x + y
        h = self._norm(p["norm2"], x)
        y, aux = self._ffn(p["ffn"], h, self._zero())
        return constrain(x + y, "batch", "seq", "embed"), aux

    def apply_hidden(self, batch):
        """The forward pass up to the final norm (no logits)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(tokens)
        if "input_embeds" in batch:
            ie = batch["input_embeds"].to(x.dtype)
            x = torch.cat([ie, x[:, ie.shape[1]:]], dim=1)
        positions = self._positions(batch, tokens)
        enc_states = enc_pos = None
        if cfg.encoder_layers:
            enc_states, enc_pos = self._encode(batch)
        aux = self._zero()
        for i in range(cfg.first_dense):
            x, a = self._dense_layer_fwd(self._tree_of(getattr(self, f"dense{i}")), x, positions)
            aux = aux + a
        for unit in self.units:
            x, a = self._remat(self._unit_call, unit, x, positions, enc_states, enc_pos)
            aux = aux + a
        return self._norm(self._tree_of(self.final_norm), x), aux

    def _unit_call(self, unit, x, positions, enc_states, enc_pos):
        return self._unit_fwd(self._tree_of(unit), x, positions, enc_states, enc_pos)

    def _chunk_nll(self, xc, tc, w):
        """(sum of the NLL over the chunk's valid targets (>= 0), their count).
        The JAX package's ``logsumexp - gold``, as ``cross_entropy`` computes
        it: its backward keeps three float32 copies of the chunk's logits
        where logsumexp's and gather's keep five."""
        logits = self._logits(xc, w)
        valid = tc >= 0
        tgt = torch.where(valid, tc, -100).long()
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1),
                              ignore_index=-100, reduction="sum")
        return nll, valid.sum()

    def _chunk_nll_tp(self, xc, tc, w, tp):
        """``_chunk_nll`` with the vocabulary split over 'model': this rank's
        logits, their logsumexp's sum of exponentials and the gold logit
        summed over the ranks."""
        logits = self._logits(tp.enter(xc), w)
        Vl = logits.shape[-1]
        valid = tc >= 0
        m = tp.group.all_reduce(logits.detach().amax(-1), "max")
        se = tp.leave(torch.exp(logits - m[..., None]).sum(-1))
        i = tc.long() - tp.rank * Vl
        mine = valid & (i >= 0) & (i < Vl)
        gold = logits.gather(-1, torch.where(mine, i, 0)[..., None])[..., 0]
        gold = tp.leave(torch.where(mine, gold, 0.0))
        nll = torch.where(valid, torch.log(se) + m - gold, 0.0).sum()
        return nll, valid.sum()

    def loss(self, batch):
        """Chunked (fused) cross-entropy of ``batch["targets"]`` plus the MoE
        aux loss, a float32 scalar: the logits are made and reduced one
        sequence chunk of ``cfg.loss_chunk`` at a time (one chunk when it does
        not divide S), each chunk checkpointed when grad is enabled, so one
        chunk's logits are live at a time in the backward pass too and the
        (B, S, V) tensor never exists. Under ``current_dp()`` the NLL sum and
        the target count are summed over the data-parallel ranks: every rank
        returns the whole batch's loss."""
        cfg = self.cfg
        x, aux = self.apply_hidden(batch)
        targets = batch["targets"]
        S = x.shape[1]
        C = min(cfg.loss_chunk, S)
        if S % C != 0:
            C = S                                   # irregular: single chunk
        table = self.embed if cfg.tie_embeddings else self.unembed
        tp = self._vocab_tp(table, 0 if cfg.tie_embeddings else 1)
        if tp is None:
            w, nll, extra = self._unembed(), self._chunk_nll, ()
        else:                               # this rank's vocabulary
            w = self.gather(table, tp=True).to(cfg.dtype)
            w, nll, extra = (w.T if cfg.tie_embeddings else w), self._chunk_nll_tp, (tp,)
        tot = self._zero()
        n = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(S // C):
            args = (x[:, i * C:(i + 1) * C], targets[:, i * C:(i + 1) * C], w) + extra
            if torch.is_grad_enabled():
                s, k = checkpoint(nll, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                s, k = nll(*args)
            tot = tot + s
            n = n + k
        dp = current_dp()
        if dp is not None:
            tot, n = dp.sum(tot), dp.all_reduce(n)
        return tot / n.clamp(min=1) + aux

    # ---------------- serving: cache / decode ----------------
    def init_cache(self, batch: int, max_len: int):
        """(caches, axes) for one decode batch: the JAX layout, G axis first."""
        cfg = self.cfg
        G = cfg.num_units

        def z(*shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        caches, axes = {}, {}
        for i, kind in enumerate(cfg.unit):
            if kind == "attn" and cfg.attention == "mla":
                m = cfg.mla
                caches[f"l{i}"] = {"c": z(G, batch, max_len, m.kv_lora_rank),
                                   "kr": z(G, batch, max_len, m.qk_rope_dim)}
                axes[f"l{i}"] = {"c": Axes(None, "batch", "kv_seq", None),
                                 "kr": Axes(None, "batch", "kv_seq", None)}
            elif kind == "attn":
                # the UNREPEATED kv heads: decode groups the query heads over them
                hkc = cfg.num_kv_heads
                caches[f"l{i}"] = {"k": z(G, batch, max_len, hkc, cfg.hd),
                                   "v": z(G, batch, max_len, hkc, cfg.hd)}
                axes[f"l{i}"] = {"k": Axes(None, "batch", "kv_seq", "kv_heads", None),
                                 "v": Axes(None, "batch", "kv_seq", "kv_heads", None)}
            elif kind == "mamba":
                mc = cfg.mamba
                caches[f"l{i}"] = {"ssm": z(G, batch, mc.d_inner, mc.d_state,
                                            dtype=torch.float32),
                                   "conv": z(G, batch, mc.d_conv - 1, mc.d_inner)}
                axes[f"l{i}"] = {"ssm": Axes(None, "batch", "d_ff", None),
                                 "conv": Axes(None, "batch", None, "d_ff")}
            else:  # rwkv
                rc = cfg.rwkv
                caches[f"l{i}"] = {"S": z(G, batch, rc.num_heads, rc.head_size, rc.head_size,
                                          dtype=torch.float32),
                                   "x_prev": z(G, batch, 1, cfg.d_model)}
                axes[f"l{i}"] = {"S": Axes(None, "batch", None, None, None),
                                 "x_prev": Axes(None, "batch", None, "embed")}
        return caches, axes

    def init_dense_cache(self, batch: int, max_len: int):
        """(caches, axes) of the ``first_dense`` layers, under ``caches["dense"]``."""
        cfg = self.cfg

        def z(*shape):
            return torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        out, axes = {}, {}
        for i in range(cfg.first_dense):
            if cfg.attention == "mla":
                m = cfg.mla
                out[f"d{i}"] = {"c": z(batch, max_len, m.kv_lora_rank),
                                "kr": z(batch, max_len, m.qk_rope_dim)}
                axes[f"d{i}"] = {"c": Axes("batch", "kv_seq", None),
                                 "kr": Axes("batch", "kv_seq", None)}
            else:
                out[f"d{i}"] = {"k": z(batch, max_len, cfg.num_kv_heads, cfg.hd),
                                "v": z(batch, max_len, cfg.num_kv_heads, cfg.hd)}
                axes[f"d{i}"] = {"k": Axes("batch", "kv_seq", "kv_heads", None),
                                 "v": Axes("batch", "kv_seq", "kv_heads", None)}
        return out, axes

    def _attn_decode(self, p, h, pos: int, cache, window):
        """One token's attention against the cache, written at ``pos``. Keys
        past ``pos`` are masked to exact zeros in the JAX package's softmax;
        the port reads the cache up to ``pos`` alone, the same sums."""
        cfg = self.cfg
        acfg = cfg.attn_cfg(window)
        B = h.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
        pos_k = torch.arange(pos + 1, dtype=torch.int32, device=h.device).expand(B, pos + 1)
        if cfg.attention == "mla":
            c_t, kr_t = L.mla_compress(p, h, positions, cfg.mla)
            cache["c"][:, pos] = c_t[:, 0]
            cache["kr"][:, pos] = kr_t[:, 0]
            y, _ = L.mla_apply(p, h, positions, cfg.mla,
                               cache=(cache["c"][:, :pos + 1], cache["kr"][:, :pos + 1]),
                               pos_k=pos_k)
            return y
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
        if acfg.qk_norm:
            q = L._qk_norm(q, p["q_norm"])
            k = L._qk_norm(k, p["k_norm"])
        if cfg.use_rope:
            mp = positions.expand(3, B, 1) if cfg.mrope_sections is not None else positions
            q = apply_rope(q, mp, acfg.rope_theta, acfg.mrope_sections)
            k = apply_rope(k, mp, acfg.rope_theta, acfg.mrope_sections)
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        kc = constrain(cache["k"], "batch", "kv_seq", "kv_heads", None)
        vc = constrain(cache["v"], "batch", "kv_seq", "kv_heads", None)
        out = L.attention(q, kc[:, :pos + 1], vc[:, :pos + 1], positions, pos_k,
                          dataclasses.replace(acfg, blocked_threshold=1 << 30), causal=True)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(h.dtype))

    @torch.no_grad()
    def decode_step(self, token, pos, caches, enc_states=None, enc_pos=None):
        """token: (B, 1) int; pos: int -> (float32 logits (B, 1, V), caches),
        the caches written in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(token)
        B = token.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        # first_dense layers (deepseek layer 0) carry their own cache entries
        # under caches["dense"] (see init_dense_cache)
        for i in range(cfg.first_dense):
            p = self._tree_of(getattr(self, f"dense{i}"))
            h = self._norm(p["norm1"], x)
            x = x + self._attn_decode(p["attn"], h, pos, caches["dense"][f"d{i}"], None)
            h = self._norm(p["norm2"], x)
            y, _ = self._ffn(p["ffn"], h, self._zero())
            x = x + y
        for g, unit in enumerate(self.units):
            up = self._tree_of(unit)
            for i, kind in enumerate(cfg.unit):
                p, c = up[f"l{i}"], caches[f"l{i}"]
                h = self._norm(p["norm1"], x)
                if kind == "attn":
                    y = self._attn_decode(p["attn"], h, pos, {n: t[g] for n, t in c.items()},
                                          self._window_for(i))
                elif kind == "mamba":
                    y, (ssm, conv) = mamba_decode(p["mamba"], h, (c["ssm"][g], c["conv"][g]),
                                                  cfg.mamba)
                    c["ssm"][g], c["conv"][g] = ssm, conv
                else:
                    y, (S, xp) = rwkv_decode(p["rwkv"], h, (c["S"][g], c["x_prev"][g]),
                                             cfg.rwkv)
                    c["S"][g], c["x_prev"][g] = S, xp
                x = x + y
                if enc_states is not None:
                    hc = self._norm(p["norm_cross"], x)
                    x = x + self._cross_attn(p["cross"], hc, positions, enc_states, enc_pos)
                h = self._norm(p["norm2"], x)
                y, _ = self._ffn(p["ffn"], h, self._zero())
                x = x + y
        x = self._norm(self._tree_of(self.final_norm), x)
        return self._logits(x), caches


def shapes_and_axes(model: Model):
    """(meta tensor tree, Axes tree) of ``model``'s parameters in the JAX
    tree's shape (``units``/``encoder`` stacked on a leading G axis),
    built on the ``meta`` device: nothing is allocated."""
    params, axes = init_params(model.cfg, None)
    for k in STACKED:
        if k in params:
            G = len(params[k])
            params[k] = _map_tree(lambda t: torch.empty((G,) + t.shape, device=META),
                                  params[k][0])
            axes[k] = _map_tree(lambda a: Axes(None, *a), axes[k])
    return params, axes


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(model: Model) -> int:
    shapes, _ = shapes_and_axes(model)
    return sum(t.numel() for t in _leaves(shapes))


__all__ = ["Model", "ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig",
           "RWKVConfig", "init_params", "shapes_and_axes", "param_count"]
