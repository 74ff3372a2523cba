"""Mamba (S6 selective SSM) layer, the Jamba hybrid's dominant block, in torch.

The counterpart of ``repro.models.mamba``. Forward path: a chunked
selective scan, a loop over sequence chunks carrying the (B, d_inner,
d_state) float32 state, with an associative (log-step) scan of the diagonal
decays inside each chunk. Decode path: one state update a token, O(1) in
sequence length. The causal depthwise conv is an explicit sum of shifted
products, as the JAX package writes it (no cuDNN convolution, which may take
TF32 on the card).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Axes, constrain
from .layers import ParamBuilder


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int                  # expand * d_model
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0              # 0 => d_model // 16
    chunk: int = 128

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def mamba_init(gen, cfg: MambaConfig):
    b = ParamBuilder(gen)
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    b.w("in_proj", (d, 2 * di), Axes("embed", "d_ff"), fan_in=d)
    b.w("conv", (cfg.d_conv, di), Axes("conv", "d_ff"), fan_in=cfg.d_conv)
    b.w("x_proj", (di, cfg.rank + 2 * n), Axes("d_ff", "state"), fan_in=di)
    b.w("dt_proj", (cfg.rank, di), Axes("state", "d_ff"), fan_in=cfg.rank)
    b.w("A_log", (di, n), Axes("d_ff", "state"), fan_in=1)
    b.w("D", (di,), Axes("d_ff"), zero=True)
    b.w("out_proj", (di, d), Axes("d_ff", "embed"), fan_in=di)
    return b.build()


def _ssm_inputs(params, xz, cfg: MambaConfig, conv_state=None):
    """Shared front end: conv + projections.

    xz: (B, S, 2*di) from in_proj. Returns (x, z, dt, Bm, Cm, new_conv_state)
    where x is post-conv/silu (B, S, di). The conv's float32 taps promote x
    to float32 from here on, as in the JAX package."""
    n = cfg.d_state
    x, z = xz.chunk(2, dim=-1)
    k = cfg.d_conv
    if conv_state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:], dtype=x.dtype, device=x.device)
    else:
        pad = conv_state                                   # (B, k-1, di)
    xp = torch.cat([pad, x], dim=1)
    new_conv_state = xp[:, -(k - 1):] if k > 1 else pad
    L = xp.shape[1]
    conv = sum(xp[:, i: L - (k - 1 - i)] * params["conv"][i] for i in range(k))
    x = F.silu(conv)
    proj = torch.einsum("bsd,dr->bsr", x, params["x_proj"].to(x.dtype))
    dt, Bm, Cm = proj.split([cfg.rank, n, n], dim=-1)
    dt = F.softplus(torch.einsum("bsr,rd->bsd", dt, params["dt_proj"].to(x.dtype)))
    return x, z, dt, Bm, Cm, new_conv_state


def _scan_chunk(decay, inp):
    """Inclusive scan along axis 1 of h_t = decay_t * h_{t-1} + inp_t from
    h = 0: (prefix products of the decays, the scanned inputs), by log-step
    doubling (the composition ``jax.lax.associative_scan`` evaluates)."""
    a, b = decay, inp
    Q = a.shape[1]
    d = 1
    while d < Q:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def mamba_apply(params, u, cfg: MambaConfig):
    """Forward/prefill path. u: (B, S, d_model) -> (y, final_state)."""
    B, S, _ = u.shape
    di, n, Q = cfg.d_inner, cfg.d_state, cfg.chunk
    xz = torch.einsum("bsd,de->bse", u, params["in_proj"].to(u.dtype))
    x, z, dt, Bm, Cm, _ = _ssm_inputs(params, xz, cfg)
    A = -torch.exp(params["A_log"].float())                # (di, n)

    nq = -(-S // Q)
    pad = nq * Q - S

    def padq(t):
        return F.pad(t, (0, 0, 0, pad))                    # zero dt: decay 1, no input

    xq, dtq, Bq, Cq = (padq(t) for t in (x, dt, Bm, Cm))
    h = torch.zeros((B, di, n), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nq):
        blk = slice(c * Q, (c + 1) * Q)
        dtf = dtq[:, blk].float()                          # (B,Q,di)
        decay = torch.exp(dtf[..., None] * A)              # (B,Q,di,n)
        inp = (dtf * xq[:, blk].float())[..., None] * Bq[:, blk].float()[:, :, None, :]
        a_cum, b_cum = _scan_chunk(decay, inp)
        hs = a_cum * h[:, None] + b_cum                    # (B,Q,di,n)
        ys.append(torch.einsum("bqdn,bqn->bqd", hs, Cq[:, blk].float()))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    y = (y + x.float() * params["D"]).to(u.dtype)
    y = y * F.silu(z)
    y = constrain(y, "batch", "seq", "d_ff")
    return torch.einsum("bsd,de->bse", y, params["out_proj"].to(u.dtype)), h


def mamba_decode(params, u, state, cfg: MambaConfig):
    """Single-token step. u: (B, 1, d); state: (ssm (B,di,n), conv (B,k-1,di))."""
    ssm, conv_state = state
    xz = torch.einsum("bsd,de->bse", u, params["in_proj"].to(u.dtype))
    x, z, dt, Bm, Cm, new_conv = _ssm_inputs(params, xz, cfg, conv_state)
    A = -torch.exp(params["A_log"].float())
    dtf = dt[:, 0].float()                                 # (B, di)
    decay = torch.exp(dtf[..., None] * A)                  # (B, di, n)
    inp = (dtf * x[:, 0].float())[..., None] * Bm[:, 0].float()[:, None, :]
    new_ssm = decay * ssm + inp
    y = torch.einsum("bdn,bn->bd", new_ssm, Cm[:, 0].float())
    y = (y + x[:, 0].float() * params["D"]).to(u.dtype)
    y = (y * F.silu(z[:, 0]))[:, None]
    out = torch.einsum("bsd,de->bse", y, params["out_proj"].to(u.dtype))
    return out, (new_ssm, new_conv)


def mamba_init_state(cfg: MambaConfig, batch: int, dtype=torch.bfloat16, device="cuda"):
    return (torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device))
