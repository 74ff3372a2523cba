"""The port's LM (``repro_torch.models``, ``repro_torch.configs``) against the
JAX package's (``repro.models``, ``repro.configs``), on the CPU.

  * **each architecture** at its smoke config, the JAX parameters carried
    across by ``convert.load_jax_params``: the forward logits and four greedy
    decode steps (seamless with its encoded zero frames) in float32 (rtol
    1e-4, atol 1e-4·max|logit|, equal greedy tokens), and in bfloat16, as
    published (max|Δ| ≤ 2e-2·max|logit|, the decode teacher-forced with the
    float32 tokens);
  * **the blocks**: the three MoE dispatches (one case dropping tokens),
    blocked attention at ``blocked_threshold=16, block_k=8``, rwkv's chunked
    and sequential time mix, mamba's chunked scan, each against the JAX
    function on the same numpy inputs;
  * **tests/test_models.py's counterparts** on the port alone: decode equals
    forward, rwkv chunked equals sequential, mamba forward equals decode, and
    the parameter counts of the full configs (on the ``meta`` device);
  * **configs**: every ``ArchSpec`` field equal to the JAX one (dtype
    mapped), ``param_axes`` equal to ``Model.init``'s axes, and
    ``load_jax_params`` refusing a missing, extra or mis-shaped leaf.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro.models import rwkv as JR
from repro.models.transformer import Model as JModel
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv as R
from repro_torch.models.convert import load_jax_params, param_axes
from repro_torch.models.transformer import Model, param_count
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

B, S, STEPS, FRAMES = 2, 8, 4, 16
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
SPEC_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.int32): torch.int32}
# bfloat16: max|Δ| over max|logit|. jamba's smoke forward (8 layers, mamba and
# MoE in bfloat16) differs by 2.5e-2 between the JAX package's own jitted and
# op-by-op evaluations of the same params and inputs (XLA rounds a fused
# chain once, op by op rounds every op), so the port is held to 3e-2 there.
BF16_TOL = {"jamba-1.5-large-398b": 3e-2}


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def close(got, want, rtol=1e-4, atol_rel=1e-4):
    want = N(want)
    np.testing.assert_allclose(N(got), want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _batch(spec, cfg, rng):
    """numpy inputs of the forward at (B, S): tokens, and the arch's extras
    (qwen2-vl's patch embeddings and M-RoPE ids, seamless's frames)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if spec.extras:
        for k, v in spec.extras("train_4k", cfg, B, S).items():
            if k == "mrope_positions":
                t = np.arange(S, dtype=np.int32)
                batch[k] = np.broadcast_to(np.stack([t, t // 2, t % 3])[:, None], v.shape).copy()
            else:
                batch[k] = rng.standard_normal(v.shape).astype(np.float32)
    return batch


def _record_routes(module, routes: list, margins: list | None = None):
    """Wrap ``module._router`` to append each call's expert choice (T, k):
    the JAX side's through an ordered debug callback (a jitted scan records
    in call order); the port's with each token's top-k margin (the k-th less
    the (k+1)-th router probability) into ``margins``. Returns the original."""
    orig = module._router

    def router(params, x, cfg):
        gates, idx, aux = orig(params, x, cfg)
        if margins is None:
            jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx, ordered=True)
        else:
            routes.append(idx.numpy())
            logits = torch.einsum("td,de->te", x.float(), params["router"].float())
            p = torch.softmax(logits, dim=-1).sort(dim=-1, descending=True).values
            margins.append((p[:, cfg.top_k - 1] - p[:, cfg.top_k]).numpy())
        return gates, idx, aux
    module._router = router
    return orig


def _jax_side(arch):
    """The JAX model's params (numpy), forward logits and decode logits in
    float32 and bfloat16 (with the bfloat16 runs' MoE routes), and its
    float32 greedy tokens."""
    spec = jget_arch(arch)
    out = {"batch": _batch(spec, spec.smoke_config, np.random.default_rng(7))}
    params = None
    for dt in (jnp.float32, jnp.bfloat16):
        cfg = dataclasses.replace(spec.smoke_config, dtype=dt)
        model = JModel(cfg)
        if params is None:
            params, _ = model.init(jax.random.PRNGKey(0))
            out["params"] = jax.tree.map(np.asarray, params)
        batch = {k: jnp.asarray(v) for k, v in out["batch"].items()}
        routes = {"apply": [], "decode": []}
        orig = _record_routes(JMoE, routes["apply"]) if dt == jnp.bfloat16 else None
        try:
            out[dt, "apply"] = np.asarray(jax.jit(model.apply)(params, batch)[0])
            jax.effects_barrier()
            if orig:
                JMoE._router = orig
                _record_routes(JMoE, routes["decode"])
            caches, _ = model.init_cache(B, 16)
            if cfg.first_dense:
                caches["dense"] = model.init_dense_cache(B, 16)[0]
            enc = ()
            if cfg.encoder_layers:
                enc = model._encode(params, {"frames": jnp.zeros((B, FRAMES, cfg.d_model))})
            step = jax.jit(model.decode_step)
            tok, logits, toks = jnp.zeros((B, 1), jnp.int32), [], []
            for pos in range(STEPS):
                if dt == jnp.bfloat16:                     # teacher-forced by f32's tokens
                    tok = jnp.asarray(out["tokens"][:, pos:pos + 1])
                lg, caches = step(params, tok, jnp.int32(pos), caches, *enc)
                logits.append(np.asarray(lg))
                tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            jax.effects_barrier()
        finally:
            if orig:
                JMoE._router = orig
        out[dt, "decode"] = np.concatenate(logits, axis=1)
        out[dt, "routes"] = routes
        if dt == jnp.float32:
            out["tokens"] = np.concatenate([np.zeros((B, 1), np.int32)] + toks, axis=1)
    return out


@pytest.fixture(scope="module")
def jax_side():
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _jax_side(arch)
        return runs[arch]
    return get


def _port(arch, params, dtype):
    cfg = dataclasses.replace(get_arch(arch).smoke_config, dtype=dtype)
    return load_jax_params(Model(cfg, device="cpu"), params)


def _port_decode(model, tokens=None):
    """STEPS greedy decode steps from token 0 (teacher-forced when ``tokens``
    is given): (logits (B, STEPS, V), tokens (B, STEPS + 1))."""
    cfg = model.cfg
    caches, _ = model.init_cache(B, 16)
    if cfg.first_dense:
        caches["dense"] = model.init_dense_cache(B, 16)[0]
    enc = ()
    if cfg.encoder_layers:
        with torch.no_grad():
            enc = model._encode({"frames": torch.zeros(B, FRAMES, cfg.d_model)})
    tok = torch.zeros((B, 1), dtype=torch.long)
    logits, toks = [], [tok]
    for pos in range(STEPS):
        if tokens is not None:
            tok = T(tokens[:, pos:pos + 1]).long()
        lg, caches = model.decode_step(tok, pos, caches, *enc)
        logits.append(lg)
        tok = lg.argmax(-1)
        toks.append(tok)
    return torch.cat(logits, dim=1), torch.cat(toks, dim=1)


def _port_apply(model, batch):
    with torch.no_grad():
        return model.apply({k: T(v) for k, v in batch.items()})[0]


def _routed_alike(theirs: list, ours: list, per_call: int, seq: int, margins: list):
    """(B, seq) mask of the positions whose every MoE route so far equals the
    JAX package's: a token routed to other experts, and in its row each later
    position (causal attention carries it on), is masked out. ``per_call``
    tokens per router call (B·S in a forward, B in a decode step, which is
    call-group ``c // layers`` of the steps). Each such token must be a near
    tie of the router, its top-k margin under 1e-2, where the two packages'
    bfloat16 roundings may order two experts either way."""
    assert len(theirs) == len(ours)
    alike = np.ones((B, seq), bool)
    calls_per_step = len(ours) // (seq if per_call == B else 1)
    for c, (j, t) in enumerate(zip(theirs, ours)):
        for r in np.nonzero((np.sort(j, 1) != np.sort(t, 1)).any(1))[0]:
            assert margins[c][r] < 1e-2, (c, r, margins[c][r])
            b, s = ((r, c // calls_per_step) if per_call == B else divmod(r, seq))
            alike[b, s:] = False
    return alike


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_logits_equal_jax_f32(jax_side, arch):
    j = jax_side(arch)
    close(_port_apply(_port(arch, j["params"], torch.float32), j["batch"]),
          j[jnp.float32, "apply"])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_logits_and_greedy_tokens_equal_jax_f32(jax_side, arch):
    j = jax_side(arch)
    logits, toks = _port_decode(_port(arch, j["params"], torch.float32))
    close(logits, j[jnp.float32, "decode"])
    assert np.array_equal(toks.numpy(), j["tokens"])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_and_decode_equal_jax_bf16(jax_side, arch):
    """As published, in bfloat16: max|Δ| ≤ 2e-2·max|logit| (BF16_TOL) at
    every position routed alike (every position, where the arch has no MoE)."""
    j = jax_side(arch)
    model = _port(arch, j["params"], torch.bfloat16)
    routes, margins = [], []
    orig = _record_routes(MoE, routes, margins)
    try:
        got = {"apply": _port_apply(model, j["batch"])}
        n_apply = len(routes)
        got["decode"] = _port_decode(model, j["tokens"])[0]
    finally:
        MoE._router = orig
    theirs = j[jnp.bfloat16, "routes"]
    for kind, seq, per_call, ours, m in (
            ("apply", S, B * S, routes[:n_apply], margins[:n_apply]),
            ("decode", STEPS, B, routes[n_apply:], margins[n_apply:])):
        alike = _routed_alike(theirs[kind], ours, per_call, seq, m)
        assert alike.mean() >= 0.5, (kind, alike)
        want = j[jnp.bfloat16, kind]
        diff = np.abs(N(got[kind]) - want)[alike]
        assert diff.max() <= BF16_TOL.get(arch, 2e-2) * np.abs(want).max(), kind


# ---------------------------------------------------------------------------
# the blocks against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch,capacity_factor", [
    ("einsum", 1.25), ("sort", 1.25), ("gsort", 1.25),
    ("einsum", 0.25), ("sort", 0.25), ("gsort", 0.25)])
def test_moe_dispatch_equals_jax(dispatch, capacity_factor):
    """(T=64 tokens, 8 experts, top 2, 4 groups); capacity factor 0.25 caps
    each expert at 8 slots (16 in a group) and drops tokens."""
    d = 32
    jcfg = JMoE.MoEConfig(num_experts=8, top_k=2, d_ff=48, num_shared=1, dispatch=dispatch,
                          capacity_factor=capacity_factor, num_groups=4)
    cfg = MoE.MoEConfig(**dataclasses.asdict(jcfg))
    jp, _ = JMoE.moe_init(jax.random.PRNGKey(3), d, jcfg)
    x = np.random.default_rng(5).standard_normal((4, 16, d)).astype(np.float32)
    jy, jaux = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = MoE.moe_apply({k: T(v) for k, v in jp.items()}, T(x), cfg)
    close(y, jy)
    close(aux, jaux)
    if capacity_factor < 1:                        # some assignment was dropped
        _, idx, _ = MoE._router({k: T(v) for k, v in jp.items()}, T(x).reshape(64, d), cfg)
        assert np.bincount(idx.reshape(-1).numpy(), minlength=8).max() > 8
    # the tie order of top-k: equal probabilities pick the lower expert first
    gates, idx = MoE._top_k(torch.tensor([[0.25, 0.25, 0.25, 0.25]]), 2)
    assert idx.tolist() == [[0, 1]]


def test_moe_capacity_equals_jax():
    for T_, k, e, f in [(64, 2, 8, 1.25), (7, 1, 16, 1.0), (4096, 8, 128, 1.25), (64, 2, 8, 0.25)]:
        jc = JMoE.MoEConfig(num_experts=e, top_k=k, d_ff=8, capacity_factor=f)
        assert MoE._capacity(T_, MoE.MoEConfig(**dataclasses.asdict(jc))) == JMoE._capacity(T_, jc)


@pytest.mark.parametrize("window,softcap,causal", [(None, None, True), (5, 50.0, True),
                                                   (None, None, False)])
def test_blocked_attention_equals_jax(window, softcap, causal):
    """Sk 37 > blocked_threshold 16: online softmax over 5 blocks of 8 (the
    last padded), against the JAX function, and causal against the full path
    (non-causal, the JAX function lets the 3 padded keys in, score 0 and value
    0, and the port does as it does)."""
    jcfg = JL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, window=window,
                         softcap=softcap, block_k=8, blocked_threshold=16)
    cfg = L.AttnConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 37, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 37, 2, 8)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37)).copy()
    want = JL.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), jcfg, causal=causal)
    got = L.attention(*(T(a) for a in (q, k, v, pos, pos)), cfg, causal=causal)
    close(got, want)
    full = L.attention(*(T(a) for a in (q, k, v, pos, pos)),
                       dataclasses.replace(cfg, blocked_threshold=1 << 30), causal=causal)
    if causal:
        close(got, full)
    else:
        assert not np.allclose(N(got), N(full), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunked", [True, False])
def test_rwkv_time_mix_equals_jax(chunked):
    jcfg = JR.RWKVConfig(d_model=32, d_ff=64, head_size=8, chunk=4)
    cfg = R.RWKVConfig(**dataclasses.asdict(jcfg))
    jp, _ = JR.rwkv_init(jax.random.PRNGKey(1), jcfg)
    # nonzero token-shift mixes and bonus, which the init leaves at zero
    rng = np.random.default_rng(2)
    p = {k: np.asarray(v) + (0.3 * rng.standard_normal(v.shape).astype(np.float32)
                             if k.startswith("maa") or k in ("bonus", "decay_base") else 0)
         for k, v in jp.items()}
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    jy, js = JR.rwkv_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                           chunked=chunked)
    y, s = R.rwkv_apply({k: T(v) for k, v in p.items()}, T(x), cfg, chunked=chunked)
    close(y, jy)
    close(s, js)


def test_mamba_forward_and_decode_equal_jax():
    jcfg = JM.MambaConfig(d_model=32, d_inner=64, d_state=8, chunk=4)
    cfg = M.MambaConfig(**dataclasses.asdict(jcfg))
    jp, _ = JM.mamba_init(jax.random.PRNGKey(3), jcfg)
    p = {k: T(v) for k, v in jp.items()}
    u = np.random.default_rng(4).standard_normal((2, 11, 32)).astype(np.float32)
    jy, jh = JM.mamba_apply(jp, jnp.asarray(u), jcfg)
    y, h = M.mamba_apply(p, T(u), cfg)
    close(y, jy)
    close(h, jh)
    jst = JM.mamba_init_state(jcfg, 2, jnp.float32)
    st = M.mamba_init_state(cfg, 2, torch.float32, device="cpu")
    for t in range(3):
        jyt, jst = JM.mamba_decode(jp, jnp.asarray(u[:, t:t + 1]), jst, jcfg)
        yt, st = M.mamba_decode(p, T(u[:, t:t + 1]), st, cfg)
        close(yt, jyt)
    close(st[0], jst[0])
    close(st[1], jst[1])


@pytest.mark.parametrize("qk_norm,sections", [(True, None), (False, (2, 1, 1))])
def test_gqa_apply_equals_jax(qk_norm, sections):
    """The self-attention block (GQA, 4 query heads over 2 KV heads) with
    qk-norm, or with M-RoPE positions (3, B, S)."""
    jcfg = JL.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, qk_norm=qk_norm,
                         mrope_sections=sections)
    cfg = L.AttnConfig(**dataclasses.asdict(jcfg))
    jp, _ = JL.gqa_init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    if sections:
        pos = np.stack([pos, pos // 2, pos % 3])
    jy, (jk, jv) = JL.gqa_apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    y, (k, v) = L.gqa_apply({n: T(a) for n, a in jp.items()}, T(x), T(pos), cfg)
    close(y, jy)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("sections", [None, (4, 2, 2)])
def test_rope_equals_jax(sections):
    x = np.random.default_rng(9).standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32).reshape(2, 6) * 37
    if sections:
        pos = np.stack([pos, pos // 2, pos % 5])
    close(L.apply_rope(T(x), T(pos), 1e6, sections),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))


# ---------------------------------------------------------------------------
# tests/test_models.py's counterparts, on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_decode_matches_forward_gqa(dtype, tol):
    """Teacher-forced decode logits == full forward logits (cache path): the
    repeated KV heads of the forward against the cache's unrepeated ones."""
    spec = get_arch("qwen3-0.6b")
    cfg = dataclasses.replace(spec.smoke_config, dtype=dtype)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, 100, (2, 8), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full, _ = model.apply({"tokens": toks})
    caches, _ = model.init_cache(2, 8)
    dec = torch.cat([model.decode_step(toks[:, t:t + 1], t, caches)[0] for t in range(8)], 1)
    np.testing.assert_allclose(N(dec), N(full), rtol=tol, atol=tol)


def test_rwkv_chunked_equals_sequential():
    cfg = R.RWKVConfig(d_model=32, d_ff=64, head_size=8, chunk=4)
    p, _ = R.rwkv_init(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((2, 13, 32), generator=torch.Generator().manual_seed(2))
    y1, s1 = R.rwkv_apply(p, x, cfg, chunked=True)
    y2, s2 = R.rwkv_apply(p, x, cfg, chunked=False)
    np.testing.assert_allclose(N(y1), N(y2), atol=2e-4)
    np.testing.assert_allclose(N(s1), N(s2), atol=2e-4)


def test_mamba_train_equals_decode():
    mc = M.MambaConfig(d_model=32, d_inner=64, d_state=8, chunk=4)
    mp, _ = M.mamba_init(torch.Generator().manual_seed(3), mc)
    u = torch.randn((2, 11, 32), generator=torch.Generator().manual_seed(4))
    y_full, hT = M.mamba_apply(mp, u, mc)
    st = M.mamba_init_state(mc, 2, torch.float32, device="cpu")
    ys = []
    for t in range(11):
        yt, st = M.mamba_decode(mp, u[:, t:t + 1], st, mc)
        ys.append(yt)
    np.testing.assert_allclose(N(y_full), N(torch.cat(ys, 1)), atol=1e-4)
    np.testing.assert_allclose(N(hT), N(st[0]), atol=1e-4)


def test_param_counts_match_names():
    """The full configs, counted on the meta device; equal to the JAX counts."""
    from repro.models.transformer import param_count as jparam_count
    expected = {
        "deepseek-v2-lite-16b": (14e9, 18e9),
        "qwen3-moe-235b-a22b": (220e9, 250e9),
        "starcoder2-15b": (14e9, 17e9),
        "gemma2-27b": (25e9, 30e9),
        "stablelm-12b": (11e9, 13.5e9),
        "qwen3-0.6b": (0.5e9, 0.8e9),
        "jamba-1.5-large-398b": (380e9, 420e9),
        "rwkv6-3b": (2.5e9, 3.5e9),
        "qwen2-vl-72b": (65e9, 80e9),
        "seamless-m4t-medium": (0.5e9, 1.5e9),
    }
    for arch, (lo, hi) in expected.items():
        model = get_arch(arch).model(device="meta")
        n = param_count(model)
        assert lo <= n <= hi, (arch, n)
        assert n == jparam_count(jget_arch(arch).model()), arch
        assert all(p.is_meta for p in model.parameters())


# ---------------------------------------------------------------------------
# configs, axes, conversion
# ---------------------------------------------------------------------------


def _fields(cfg):
    """A config as a dict, dataclasses nested, the dtype mapped to torch's."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = DTYPES.get(d["dtype"], d["dtype"])
    return d


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_spec_equals_jax(arch):
    ours, theirs = get_arch(arch), jget_arch(arch)
    assert _fields(ours.config) == _fields(theirs.config)
    assert _fields(ours.smoke_config) == _fields(theirs.smoke_config)
    assert ours.config.dtype == torch.bfloat16
    for f in ("name", "skips", "rules", "opt_bits"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.extras is None) == (theirs.extras is None)
    for shape in SHAPES:
        for smoke in (True, False):
            got, want = ours.input_specs(shape, smoke), theirs.input_specs(shape, smoke)
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.is_meta and tuple(t.shape) == tuple(want[k].shape), (shape, k)
                assert t.dtype == SPEC_DTYPES[jnp.dtype(want[k].dtype)], (shape, k)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium", "rwkv6-3b"])
def test_param_axes_equal_jax_init_axes(arch):
    _, want = JModel(jget_arch(arch).smoke_config).init(jax.random.PRNGKey(0))
    assert param_axes(get_arch(arch).model(smoke=True, device="meta")) == want


def test_state_dict_keys_read_like_the_jax_paths():
    model = get_arch("deepseek-v2-lite-16b").model(smoke=True, device="meta")
    keys = set(model.state_dict())
    assert {"embed", "unembed", "dense0.attn.w_dkv", "units.0.l0.ffn.router",
            "units.1.l0.attn.kv_norm.scale", "final_norm.scale"} <= keys
    assert len(model.units) == 2


def test_load_jax_params_refuses_a_missing_extra_or_misshaped_leaf():
    spec = jget_arch("qwen3-0.6b")
    params, _ = JModel(spec.smoke_config).init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    model = get_arch("qwen3-0.6b").model(smoke=True, device="cpu")
    before = model.embed.detach().clone()
    missing = {**params, "units": {**params["units"], "l0": {
        k: v for k, v in params["units"]["l0"].items() if k != "norm2"}}}
    with pytest.raises(ValueError, match=r"missing \['units\.l0\.norm2\.scale'\]"):
        load_jax_params(model, missing)
    with pytest.raises(ValueError, match=r"extra \['unembed'\]"):
        load_jax_params(model, {**params, "unembed": params["embed"].T})
    with pytest.raises(ValueError, match="units.l0.attn.wq has shape"):
        bad = jax.tree.map(lambda a: a, params)
        bad["units"]["l0"]["attn"]["wq"] = bad["units"]["l0"]["attn"]["wq"][:1]
        load_jax_params(model, bad)
    assert torch.equal(model.embed.detach(), before)          # nothing written
    load_jax_params(model, params)
    assert np.array_equal(model.units[1].l0.attn.wq.detach().numpy(),
                          params["units"]["l0"]["attn"]["wq"][1])


def test_model_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: Model(device='cuda') runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_arch("qwen3-0.6b").model(smoke=True)


# ---------------------------------------------------------------------------
# the launcher's --arch path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_serve_arch_decodes(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--batch", "2", "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(rf"^\[serve\] {re.escape(arch)}: 2x4 tokens in [\d.]+s = [\d.]+ tok/s$",
                     out, re.M), out
    assert re.search(r"^\[serve\] sample: \[0(, \d+){4}\]$", out, re.M), out


def test_greedy_decode_equals_the_jax_launchers_loop():
    """``greedy_decode`` on JAX weights gives the tokens of the JAX launcher's
    loop (jitted decode steps, argmax of the last position), in float32."""
    spec = jget_arch("rwkv6-3b")
    cfg = dataclasses.replace(spec.smoke_config, dtype=jnp.float32)
    jmodel = JModel(cfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    caches, _ = jmodel.init_cache(2, 16)
    step = jax.jit(jmodel.decode_step)
    tok, want = jnp.zeros((2, 1), jnp.int32), [np.zeros((2, 1), np.int32)]
    for i in range(6):
        logits, caches = step(params, tok, jnp.int32(i), caches)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)[..., 0][:, None]
        want.append(np.asarray(tok))
    from repro_torch.launch.serve import greedy_decode
    model = _port("rwkv6-3b", jax.tree.map(np.asarray, params), torch.float32)
    seqs, seconds = greedy_decode(model, 2, 6, 16)
    assert np.array_equal(seqs.numpy(), np.concatenate(want, axis=1)) and seconds > 0


def test_launch_serve_arch_wants_a_card_by_default():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the launcher decodes there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-3b", "--batch", "2", "--tokens", "2"])
    with pytest.raises(SystemExit, match="--arch must be one of"):
        serve.main(["--arch", "gpt-2", "--device", "cpu"])
