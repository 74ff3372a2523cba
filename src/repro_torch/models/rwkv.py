"""RWKV-6 "Finch" time-mix / channel-mix blocks, in torch.

The counterpart of ``repro.models.rwkv``. Data-dependent decay: w_t comes
per token through a low-rank path from the token-shifted input; the state
is matrix-valued per head, S_t = diag(w_t) S_{t-1} + k_t v_tᵀ, kept in
float32. The forward path runs chunk-parallel (``_wkv_chunked``: an
intra-chunk pairwise-decay contraction plus one carried-state product a
chunk) or sequentially (``_wkv_sequential``, the reference); decode is one
state update a token.

The channel mix token-shifts against ``x_prev``, zeros when it is not given.
The model's decode step gives it none (``Model._ffn``, as the JAX package's
does), so in decode every step's channel mix shifts against zeros.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Axes, constrain
from .layers import ParamBuilder


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_size: int = 64
    decay_lora: int = 64
    chunk: int = 32

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_size


def rwkv_init(gen, cfg: RWKVConfig):
    b = ParamBuilder(gen)
    d, H, hs = cfg.d_model, cfg.num_heads, cfg.head_size
    for name in ("maa_r", "maa_k", "maa_v", "maa_w", "maa_g"):
        b.w(name, (d,), Axes("embed"), zero=True)          # token-shift mix
    b.w("w_r", (d, d), Axes("embed", "heads"), fan_in=d)
    b.w("w_k", (d, d), Axes("embed", "heads"), fan_in=d)
    b.w("w_v", (d, d), Axes("embed", "heads"), fan_in=d)
    b.w("w_g", (d, d), Axes("embed", "heads"), fan_in=d)
    b.w("w_o", (d, d), Axes("heads", "embed"), fan_in=d)
    b.w("decay_base", (d,), Axes("embed"), zero=True)
    b.w("decay_lora_a", (d, cfg.decay_lora), Axes("embed", "state"), fan_in=d)
    b.w("decay_lora_b", (cfg.decay_lora, d), Axes("state", "embed"), fan_in=cfg.decay_lora)
    b.w("bonus", (H, hs), Axes("heads", "head_dim"), zero=True)  # time_faaaa
    b.ones("ln_x", (d,), Axes("embed"))
    return b.build()


def _timeshift(x, last=None):
    """x_{t-1} with zero (or cache) at t=0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _rkvwg(params, x, x_prev):
    """Token-shift mixing + projections; returns r, k, v, w, g (w float32)."""
    def mix(maa):
        return x + (x_prev - x) * params[maa].to(x.dtype)

    def proj(maa, w):
        return torch.einsum("bsd,de->bse", mix(maa), params[w].to(x.dtype))

    r, k, v = proj("maa_r", "w_r"), proj("maa_k", "w_k"), proj("maa_v", "w_v")
    g = F.silu(proj("maa_g", "w_g"))
    lora = torch.einsum("bsr,rd->bsd", torch.tanh(
        torch.einsum("bsd,dr->bsr", mix("maa_w"), params["decay_lora_a"].to(x.dtype))),
        params["decay_lora_b"].to(x.dtype))
    w = torch.exp(-torch.exp((params["decay_base"] + lora).float()))
    return r, k, v, w, g                                   # w: (B,S,d) in (0,1)


def _heads(t, H, hs):
    return t.reshape(t.shape[0], t.shape[1], H, hs)


def _ln_x(params, y, H, hs):
    """Group norm per head (population variance), float32, then ln_x."""
    B, S = y.shape[:2]
    yf = y.float().reshape(B, S, H, hs)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    return ((yf - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, H * hs) * params["ln_x"]


def rwkv_apply(params, x, cfg: RWKVConfig, chunked: bool = True):
    """Time-mix block. x: (B, S, d) -> (y, final_state (B,H,hs,hs))."""
    B, S, d = x.shape
    H, hs = cfg.num_heads, cfg.head_size
    r, k, v, w, g = _rkvwg(params, x, _timeshift(x))
    r, k, v, w = (_heads(t, H, hs) for t in (r, k, v, w))
    bonus = params["bonus"].float()
    if chunked:
        y, state = _wkv_chunked(r, k, v, w, bonus, cfg.chunk)
    else:
        y, state = _wkv_sequential(r, k, v, w, bonus)
    y = _ln_x(params, y.reshape(B, S, d), H, hs).to(x.dtype) * g
    y = constrain(y, "batch", "seq", "heads")
    return torch.einsum("bsd,de->bse", y, params["w_o"].to(x.dtype)), state


def _wkv_sequential(r, k, v, w, bonus):
    """Reference: a loop over time. r, k, v, w: (B,S,H,hs)."""
    B, S, H, hs = r.shape
    Sm = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    r, k, v, w = (t.float() for t in (r, k, v, w))
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hs,hs)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], Sm + bonus[..., None] * kv))
        Sm = w[:, t, :, :, None] * Sm + kv
    return torch.stack(ys, dim=1).reshape(B, S, H * hs), Sm


def _wkv_chunked(r, k, v, w, bonus, Q):
    """Chunk-parallel WKV: intra-chunk 'attention' product + carried state.

    Within a chunk, out_t = r_t · (decay-weighted Σ_{s<t} k_s v_sᵀ + bonus
    kv_t) splits into a causal (Q x Q) pairwise-decay contraction and one
    state-carry product a chunk. Every exponent is a log-decay difference
    over a forward interval, hence <= 0: no overflow.
    """
    B, S, H, hs = r.shape
    nq = -(-S // Q)
    pad = nq * Q - S

    def prep(t, value=0.0):
        t = F.pad(t.float(), (0, 0, 0, 0, 0, pad), value=value)
        t = t.reshape(B, nq, Q, H, hs).permute(1, 0, 3, 2, 4).reshape(nq, B * H, Q, hs)
        return constrain(t, None, "batch", None, None)

    rq, kq, vq = prep(r), prep(k), prep(v)
    wq = prep(w, 1.0)      # pad decay with 1: phantom steps don't touch the state
    logw = torch.log(torch.clamp(wq, min=1e-38))           # (nq,BH,Q,hs)
    cum = torch.cumsum(logw, dim=2)                        # inclusive Σ_{u<=s}
    bonus_m = bonus.repeat(B, 1)                           # (BH, hs)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device), -1)

    Sm = torch.zeros((B * H, hs, hs), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nq):
        rc, kc, vc, lw, cw = rq[c], kq[c], vq[c], logw[c], cum[c]   # (BH,Q,hs)
        excl = cw - lw                                     # Σ_{u<q} log w_u
        # pairwise coefficient: Π_{u in (s, q-1]} w_u = exp(excl_q - cum_s) <= 1
        diff = excl[:, :, None, :] - cw[:, None, :, :]     # (BH,Q,Q,hs)
        att = torch.einsum("bqk,bsk,bqsk->bqs", rc, kc, torch.exp(torch.clamp(diff, max=0.0)))
        att = torch.where(causal, att, 0.0)
        intra = torch.einsum("bqs,bsv->bqv", att, vc)
        diag = torch.einsum("bqk,bk,bqk,bqv->bqv", rc, bonus_m, kc, vc)
        carry = torch.einsum("bqk,bkv->bqv", rc * torch.exp(excl), Sm)
        outs.append(intra + diag + carry)
        # state: S' = diag(Π_chunk w) S + Σ_s (Π_{u>s} w_u) k_s v_sᵀ
        total = cw[:, -1:]                                 # (BH,1,hs)
        k_carry = kc * torch.exp(total - cw)
        Sm = torch.exp(total[:, 0])[:, :, None] * Sm + torch.einsum("bqk,bqv->bkv", k_carry, vc)
        Sm = constrain(Sm, "batch", None, None)
    y = torch.stack(outs).reshape(nq, B, H, Q, hs).permute(1, 0, 3, 2, 4)
    y = y.reshape(B, nq * Q, H * hs)[:, :S]
    return y, Sm.reshape(B, H, hs, hs)


def rwkv_decode(params, x, state, cfg: RWKVConfig):
    """Single-token step. state = (S (B,H,hs,hs), x_prev (B,1,d))."""
    Sm, x_prev = state
    B = x.shape[0]
    H, hs = cfg.num_heads, cfg.head_size
    r, k, v, w, g = _rkvwg(params, x, x_prev)
    rt, kt, vt, wt = (t[:, 0].reshape(B, H, hs) for t in (r, k, v, w))
    bonus = params["bonus"].float()
    kv = kt[..., :, None].float() * vt[..., None, :].float()
    out = torch.einsum("bhk,bhkv->bhv", rt.float(), Sm + bonus[..., None] * kv)
    Sm = wt[..., None] * Sm + kv
    y = _ln_x(params, out.reshape(B, 1, H * hs), H, hs).to(x.dtype) * g
    return torch.einsum("bsd,de->bse", y, params["w_o"].to(x.dtype)), (Sm, x)


def rwkv_channel_init(gen, cfg: RWKVConfig):
    b = ParamBuilder(gen)
    d, f = cfg.d_model, cfg.d_ff
    b.w("maa_k", (d,), Axes("embed"), zero=True)
    b.w("maa_r", (d,), Axes("embed"), zero=True)
    b.w("w_k", (d, f), Axes("embed", "d_ff"), fan_in=d)
    b.w("w_v", (f, d), Axes("d_ff", "embed"), fan_in=f)
    b.w("w_r", (d, d), Axes("embed", "heads"), fan_in=d)
    return b.build()


def rwkv_channel_apply(params, x, x_prev=None):
    xs = _timeshift(x, x_prev)
    xk = x + (xs - x) * params["maa_k"].to(x.dtype)
    xr = x + (xs - x) * params["maa_r"].to(x.dtype)
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, params["w_k"].to(x.dtype))))
    kv = torch.einsum("bsf,fd->bsd", k, params["w_v"].to(x.dtype))
    return torch.sigmoid(torch.einsum("bsd,de->bse", xr, params["w_r"].to(x.dtype))) * kv
