"""The port's LM partition rules (``repro_torch.distributed.sharding``,
``train.optimizer.zero_axes`` / ``opt_state_shardings``,
``train.train_step.shardings_for`` / ``batch_shardings``) against the JAX
package's: ``tests/test_sharding.py``'s five tests, then every parameter,
optimizer-state (32- and 8-bit, master weights), batch and decode-cache spec
of the ten architectures' full configs on both production meshes (abstract
meshes: sizes only), leaf for leaf."""
import jax
import pytest

from repro.configs import ARCH_NAMES as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as JS
from repro.models.transformer import Model as JModel
from repro.models.transformer import shapes_and_axes as jshapes_and_axes
from repro.train import optimizer as JO
from repro.train.train_step import batch_shardings as jbatch_shardings
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.distributed.sharding import (DEFAULT_RULES, FSDP_RULES, Axes, P,
                                              abstract_mesh, constrain, logical_to_physical,
                                              mesh_context, named_sharding, shard_params_tree,
                                              spec_placements)
from repro_torch.launch.dryrun import _cache_shapes_and_axes
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import batch_shardings, shardings_for

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def mk_mesh(shape, names):
    return abstract_mesh(shape, names)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's five, on the port
# ---------------------------------------------------------------------------


def test_divisibility_drop():
    mesh = mk_mesh((16, 16), ("data", "model"))
    spec = logical_to_physical(Axes("batch", "seq", "kv_heads", "head_dim"),
                               mesh, DEFAULT_RULES, (256, 128, 4, 64))
    assert spec == P("data", None, None, None)
    spec = logical_to_physical(Axes("batch", "seq", "kv_heads", "head_dim"),
                               mesh, DEFAULT_RULES, (256, 128, 16, 64))
    assert spec == P("data", None, "model", None)


def test_axis_used_once():
    mesh = mk_mesh((16, 16), ("data", "model"))
    spec = logical_to_physical(Axes("vocab", "d_ff"), mesh, DEFAULT_RULES, (160, 160))
    assert spec == P("model", None)


def test_multi_pod_batch():
    mesh = mk_mesh((2, 16, 16), ("pod", "data", "model"))
    spec = logical_to_physical(Axes("batch", "seq", "embed"), mesh,
                               DEFAULT_RULES, (256, 4096, 1024))
    assert spec == P(("pod", "data"), None, None)
    spec_f = logical_to_physical(Axes("embed", "d_ff"), mesh, FSDP_RULES, (1024, 4096))
    assert spec_f == P("data", "model")


def test_zero_axes_picks_replicated_dim():
    mesh = mk_mesh((16, 16), ("data", "model"))
    za = O.zero_axes(Axes("embed", "d_ff"), (1024, 4096), mesh, DEFAULT_RULES)
    assert za == ("opt", "d_ff")
    spec = logical_to_physical(za, mesh, DEFAULT_RULES, (1024, 4096))
    assert spec == P("data", "model")


def test_constrain_noop_without_mesh():
    import torch
    x = torch.ones((4, 4))
    assert constrain(x, "batch", "embed") is x


def test_rules_and_placements():
    """The rule dicts are the JAX package's; placements nest a two-axis
    dimension in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    assert DEFAULT_RULES.rules == JS.DEFAULT_RULES.rules
    assert FSDP_RULES.rules == JS.FSDP_RULES.rules
    mesh = mk_mesh((2, 16, 16), ("pod", "data", "model"))
    ns = named_sharding(Axes("embed", "d_ff"), mesh, DEFAULT_RULES.replace(embed=("data", "pod")),
                        (1024, 4096))
    assert tuple(ns.spec) == (("data", "pod"), "model")
    assert ns.placements == (Shard(0), Shard(0), Shard(1))
    assert ns.shard_shape((1024, 4096)) == (32, 256)
    assert spec_placements(P(None, None), mesh) == (Replicate(),) * 3


# ---------------------------------------------------------------------------
# every leaf of every full config, both production meshes
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (keys sorted)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _specs(tree) -> dict:
    return {k: tuple(v.spec) for k, v in _flat(tree).items()}


def _jax_cache(model, batch, max_len):
    """``repro.launch.dryrun._cache_shapes_and_axes`` (that module forces 512
    host devices at import, so its function is restated here)."""
    box = {}

    def build():
        c, a = model.init_cache(batch, max_len)
        box["axes"] = a
        if model.cfg.first_dense:
            d, da = model.init_dense_cache(batch, max_len)
            c["dense"] = d
            box["axes"]["dense"] = da
        return c
    return jax.eval_shape(build), box["axes"]


@pytest.fixture(scope="module")
def models():
    assert list(ARCH_NAMES) == list(JARCHS) and list(SHAPES) == list(JSHAPES)
    out = {}
    for a in ARCH_NAMES:
        jm = JModel(jget_arch(a).config)
        out[a] = (jm, jshapes_and_axes(jm), Model(get_arch(a).config, device="meta"))
    return out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_full_config_specs_equal_jax(models, mesh_name):
    shape, names = MESHES[mesh_name]
    pmesh, jmesh = abstract_mesh(shape, names), JS.abstract_mesh(shape, names)
    checked = 0
    for a in ARCH_NAMES:
        spec, jspec = get_arch(a), jget_arch(a)
        rules = FSDP_RULES if spec.rules == "fsdp" else DEFAULT_RULES
        jrules = JS.FSDP_RULES if jspec.rules == "fsdp" else JS.DEFAULT_RULES
        jm, (jshapes, jaxes), pm = models[a]
        # parameters, and 32- and 8-bit state with master weights
        for bits in (32, 8):
            cfg = O.OptConfig(state_bits=bits, master_weights=True)
            jcfg = JO.OptConfig(state_bits=bits, master_weights=True)
            p_shard, o_shard, _, _ = shardings_for(pm, pmesh, rules, cfg)
            jp = JS.shard_params_tree(jshapes, jaxes, jmesh, jrules)
            jo = JO.opt_state_shardings(jshapes, jaxes, jmesh, jrules, jcfg)
            got, want = _specs(p_shard), _specs(jp)
            assert got == want, (a, mesh_name, "params")
            got, want = _specs(o_shard), _specs(jo)
            assert got == want, (a, mesh_name, bits, "opt")
            checked += len(got)
        # every SHAPES entry's batch, and each decode entry's caches
        for name, sh in SHAPES.items():
            sh = dict(sh, name=name)
            b = batch_shardings(spec.input_specs_for(pm.cfg, sh), pmesh, rules)
            jb = jbatch_shardings(jspec.input_specs_for(jm.cfg, sh), jmesh, jrules)
            assert {k: tuple(v.spec) for k, v in b.items()} == \
                {k: tuple(v.spec) for k, v in jb.items()}, (a, mesh_name, name)
            if sh["kind"] != "decode" or name in spec.skips:
                continue
            cs, ca = _cache_shapes_and_axes(pm, sh["batch"], sh["seq"])
            jcs, jca = _jax_cache(jm, sh["batch"], sh["seq"])
            got = _specs(shard_params_tree(cs, ca, pmesh, rules))
            want = _specs(JS.shard_params_tree(jcs, jca, jmesh, jrules))
            assert got == want, (a, mesh_name, name, "caches")
            checked += len(got)
    assert checked > 1000


def test_zero_on_unit_axis_is_per_device_bytes_alike():
    """Where ZeRO puts 'opt' on a stacked leaf's unit axis G (rwkv6-3b on
    the single-pod mesh), the port's per-unit leaf takes it on a dimension
    of its own: each device holds as many bytes of every such leaf."""
    import math

    from repro_torch.models.transformer import shapes_and_axes
    from repro_torch.train.train_step import model_axes
    mesh = abstract_mesh(*MESHES["single"])
    pm = Model(get_arch("rwkv6-3b").config, device="meta")
    shapes, axes = shapes_and_axes(pm)
    unit_axes = model_axes(pm)["units"][0]
    on_g = 0
    for path, ax in _flat(axes["units"]).items():
        t = _flat(shapes["units"])[path]
        za = O.zero_axes(ax, tuple(t.shape), mesh, DEFAULT_RULES)
        if za[0] != "opt":
            continue
        on_g += 1
        uax = _flat(unit_axes)[path] if isinstance(unit_axes, dict) else unit_axes
        ushape = tuple(t.shape[1:])
        stacked = named_sharding(za, mesh, DEFAULT_RULES, tuple(t.shape))
        per_unit = named_sharding(O.zero_axes(uax, ushape, mesh, DEFAULT_RULES), mesh,
                                  DEFAULT_RULES, ushape)
        assert math.prod(stacked.shard_shape(tuple(t.shape))) == \
            t.shape[0] * math.prod(per_unit.shard_shape(ushape)), path
    assert on_g > 0


def test_step_context_is_seen_by_other_threads():
    """The mesh and data-parallel contexts are process-wide: torch's autograd
    engine runs a CUDA backward (the checkpointed units' recompute, which
    reads the MoE capacity from the context) on threads of its own."""
    import threading

    from repro_torch.distributed.sharding import current_dp, current_mesh, data_parallel
    mesh, dp, seen = mk_mesh((2, 2), ("data", "model")), object(), []
    with mesh_context(mesh), data_parallel(dp):
        t = threading.Thread(target=lambda: seen.append((current_mesh()[0], current_dp())))
        t.start()
        t.join()
    assert seen == [(mesh, dp)]
    assert current_mesh()[0] is None and current_dp() is None
