"""Shared transformer building blocks for the ten architectures, in torch.

The counterpart of ``repro.models.layers``, function for function. Every
block has ``<block>_init(gen, ...) -> (params, axes)`` and
``<block>_apply(params, x, ...)``: ``params`` is a nested dict of float32
tensors, ``axes`` mirrors it with ``Axes`` leaves (the logical names that
``distributed.sharding`` resolves to placements on a mesh). ``constrain``
stands where the JAX package constrains an activation's sharding: it
returns ``x`` itself with no mesh context, and redistributes a DTensor
under one.

Params are stored in float32 and cast to the activations' dtype at each
use; scores, softmax and norms run in float32 as the JAX package runs them,
so the two agree in bfloat16 within rounding.

Covers: GQA attention with qk-norm (qwen3), logit softcapping (gemma2),
sliding-window masks (gemma2 local layers), RoPE and M-RoPE (qwen2-vl), MLA
compressed-KV attention (deepseek-v2), blocked online-softmax attention for
long contexts, SwiGLU/GELU MLPs, RMSNorm.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Axes, constrain

META = torch.device("meta")


class ParamBuilder:
    """Accumulates (params, axes) pairs with fan-in scaled gaussian init.

    Draws come from ``gen`` (a ``torch.Generator``) on its device; with
    ``gen=None`` every leaf is an empty tensor on the ``meta`` device, so
    full configurations are shaped and counted without allocating."""

    def __init__(self, gen: torch.Generator | None, dtype=torch.float32):
        self.gen = gen
        self.dtype = dtype
        self.params: dict = {}
        self.axes: dict = {}

    def _empty(self, shape):
        return torch.empty(shape, dtype=self.dtype, device=META)

    def w(self, name: str, shape, axes: Axes, fan_in: int | None = None,
          zero: bool = False):
        shape = tuple(shape)
        if self.gen is None:
            arr = self._empty(shape)
        elif zero:
            arr = torch.zeros(shape, dtype=self.dtype, device=self.gen.device)
        else:
            scale = 1.0 / math.sqrt(fan_in if fan_in else shape[0])
            arr = (torch.randn(shape, generator=self.gen, dtype=torch.float32,
                               device=self.gen.device) * scale).to(self.dtype)
        self.params[name] = arr
        self.axes[name] = axes
        return arr

    def ones(self, name: str, shape, axes: Axes):
        shape = tuple(shape)
        self.params[name] = (self._empty(shape) if self.gen is None else
                             torch.ones(shape, dtype=self.dtype, device=self.gen.device))
        self.axes[name] = axes

    def sub(self, name: str, params, axes):
        self.params[name] = params
        self.axes[name] = axes

    def build(self):
        return self.params, self.axes


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(gen, d: int):
    b = ParamBuilder(gen)
    b.ones("scale", (d,), Axes("embed"))
    return b.build()


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * params["scale"]).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotary embedding over split halves. x: (B, S, ..., head_dim);
    positions: (B, S) for standard RoPE or (3, B, S) for M-RoPE (qwen2-vl),
    where ``sections`` splits head_dim // 2 frequencies over (t, h, w)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)              # (hd/2,)
    if positions.ndim == 3:                               # M-RoPE
        if sections is None or sum(sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {sections} must sum to {hd // 2}")
        parts = []
        off = 0
        for s, sec in enumerate(sections):
            parts.append(positions[s].float()[..., None] * freqs[off: off + sec])
            off += sec
        angles = torch.cat(parts, dim=-1)                 # (B, S, hd/2)
    else:
        angles = positions.float()[..., None] * freqs     # (B, S, hd/2)
    while angles.ndim < x.ndim:
        angles = angles[..., None, :]                     # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA family)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False          # qwen3
    softcap: float | None = None   # gemma2 logit softcapping
    window: int | None = None      # sliding-window (gemma2 local layers)
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl
    block_k: int = 1024            # online-softmax KV block
    blocked_threshold: int = 8192  # use the blocked path when S_k exceeds this


def gqa_init(gen, cfg: AttnConfig):
    b = ParamBuilder(gen)
    d, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.w("wq", (d, H, hd), Axes("embed", "heads", "head_dim"), fan_in=d)
    b.w("wk", (d, Hk, hd), Axes("embed", "kv_heads", "head_dim"), fan_in=d)
    b.w("wv", (d, Hk, hd), Axes("embed", "kv_heads", "head_dim"), fan_in=d)
    b.w("wo", (H, hd, d), Axes("heads", "head_dim", "embed"), fan_in=H * hd)
    if cfg.qk_norm:
        b.ones("q_norm", (hd,), Axes("head_dim"))
        b.ones("k_norm", (hd,), Axes("head_dim"))
    return b.build()


def _qk_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def _mask(pos_q, pos_k, causal: bool, window: int | None):
    """(B, Sq, Sk) boolean allow-mask from (B, Sq)/(B, Sk) position vectors."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    full = torch.broadcast_shapes(pq.shape, pk.shape)
    m = (pk <= pq) if causal else torch.ones(full, dtype=torch.bool, device=pq.device)
    m = m.expand(full)
    if window is not None:
        m = m & (pq - pk < window)
    return m


def _sdpa_full(q, k, v, pos_q, pos_k, causal, window, softcap):
    """q: (B,Sq,Hk,G,hd), k/v: (B,Sk,Hk,hd). Materialised-scores path."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float() * scale, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(pos_q, pos_k, causal, window)           # (B,Sq,Sk)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _sdpa_blocked(q, k, v, pos_q, pos_k, causal, window, softcap, block_k):
    """Online softmax over KV blocks: O(block) memory, the long-context path."""
    B, Sq, Hk, G, hd = q.shape
    Sk = k.shape[1]
    nb = -(-Sk // block_k)
    pad = nb * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=torch.iinfo(torch.int32).max)
    scale = hd ** -0.5
    qf = q.float() * scale
    m = torch.full((B, Hk, G, Sq), -math.inf, dtype=torch.float32, device=q.device)
    lse = torch.zeros((B, Hk, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hk, G, Sq, hd), dtype=torch.float32, device=q.device)
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, blk].float())
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _mask(pos_q, pos_k[:, blk], causal, window)
        s = torch.where(mask[:, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        lse = lse * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, blk].float())
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)        # (B,Sq,Hk,G,hd)


def attention(q, k, v, pos_q, pos_k, cfg: AttnConfig, causal: bool = True):
    """q: (B,Sq,H,hd) flat heads; k/v: (B,Sk,Hk,hd). Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, hd)
    qg = constrain(qg, "batch", "seq", "kv_heads", "heads", "head_dim")
    if k.shape[1] > cfg.blocked_threshold:
        out = _sdpa_blocked(qg, k, v, pos_q, pos_k, causal, cfg.window,
                            cfg.softcap, cfg.block_k)
    else:
        out = _sdpa_full(qg, k, v, pos_q, pos_k, causal, cfg.window, cfg.softcap)
    return out.reshape(B, Sq, H, hd)


def gqa_apply(params, x, positions, cfg: AttnConfig, causal: bool = True,
              kv_override=None, pos_k=None):
    """Self-attention (kv_override=None) or cross/cached attention."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
        pos_kv = positions
    else:
        k, v = kv_override
        pos_kv = pos_k
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"]) if kv_override is None else k
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    if kv_override is None:
        k = apply_rope(k, pos_kv, cfg.rope_theta, cfg.mrope_sections)
    out = attention(q, k, v, positions if positions.ndim == 2 else positions[0],
                    pos_kv if pos_kv.ndim == 2 else pos_kv[0], cfg, causal)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)), (k, v)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): compressed-KV attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4
    block_k: int = 1024
    blocked_threshold: int = 8192


def mla_init(gen, cfg: MLAConfig):
    b = ParamBuilder(gen)
    d, H = cfg.d_model, cfg.num_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    b.w("wq", (d, H, qd), Axes("embed", "heads", "head_dim"), fan_in=d)
    b.w("w_dkv", (d, cfg.kv_lora_rank), Axes("embed", "state"), fan_in=d)
    b.w("w_kr", (d, cfg.qk_rope_dim), Axes("embed", "head_dim"), fan_in=d)
    b.w("w_uk", (cfg.kv_lora_rank, H, cfg.qk_nope_dim),
        Axes("state", "heads", "head_dim"), fan_in=cfg.kv_lora_rank)
    b.w("w_uv", (cfg.kv_lora_rank, H, cfg.v_head_dim),
        Axes("state", "heads", "head_dim"), fan_in=cfg.kv_lora_rank)
    b.w("wo", (H, cfg.v_head_dim, d), Axes("heads", "head_dim", "embed"),
        fan_in=H * cfg.v_head_dim)
    n, na = rmsnorm_init(gen, cfg.kv_lora_rank)
    b.sub("kv_norm", n, na)
    return b.build()


def mla_compress(params, x, positions, cfg: MLAConfig):
    """x -> (c_kv, k_rope): the decode cache content (B,S,lora), (B,S,rope)."""
    c = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(x.dtype))
    c = rmsnorm(params["kv_norm"], c)
    kr = torch.einsum("bsd,dr->bsr", x, params["w_kr"].to(x.dtype))
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def mla_apply(params, x, positions, cfg: MLAConfig, cache=None, pos_k=None):
    """Absorbed attention over the compressed cache: W_uk is folded into the
    query and W_uv into the output, so attention runs over c_kv directly and
    the cache never expands (the forward compresses its own keys first)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    if cache is None:
        c, kr = mla_compress(params, x, positions, cfg)
        pos_k = positions
    else:
        c, kr = cache
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(x.dtype))
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), c.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())) * scale
    mask = _mask(positions, pos_k, True, None)
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    attn_c = torch.einsum("bhst,btr->bshr", p.to(c.dtype), c)
    out = torch.einsum("bshr,rhk->bshk", attn_c, params["w_uv"].to(x.dtype))
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, (c, kr)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, d_model: int, d_ff: int, gated: bool = True):
    b = ParamBuilder(gen)
    if gated:
        b.w("w_gate", (d_model, d_ff), Axes("embed", "d_ff"), fan_in=d_model)
    b.w("w_up", (d_model, d_ff), Axes("embed", "d_ff"), fan_in=d_model)
    b.w("w_down", (d_ff, d_model), Axes("d_ff", "embed"), fan_in=d_ff)
    return b.build()


def mlp_apply(params, x, act: str = "silu"):
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    if "w_gate" in params:
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
        h = (F.silu(g) if act == "silu" else gelu(g)) * up
    else:
        h = gelu(up) if act == "gelu" else F.silu(up)
    h = constrain(h, "batch", "seq", "d_ff")
    return torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
