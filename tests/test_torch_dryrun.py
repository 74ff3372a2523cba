"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: ``tests/test_dryrun_small.py``'s five architectures' train step
traced by ``trace_train`` on a fake 8-rank (2, 2, 2) ('pod', 'data',
'model') mesh (a ``fake`` process group in a subprocess), each cell's
per-device argument bytes equal to what the JAX ``lower_train`` hands XLA
there (the sum of its arguments' shard bytes, computed in a subprocess with
8 forced host devices, no compile); then one prefill and one decode
``run_cell`` on a production mesh with small overrides."""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["qwen3-0.6b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "rwkv6-3b",
         "seamless-m4t-medium"]

# the small twin of a production train cell, built as test_dryrun_small.py
# builds its own: the smoke config at input_specs(smoke=True)'s shapes,
# traced by the dry run's trace_train on a fake 8-rank world
PORT = r"""
import json, sys, tempfile
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch.dryrun import _fake_model, _rules_for, fake_world, run_cell, trace_train
from repro_torch.launch.mesh import device_mesh
from repro_torch.roofline.analysis import H100, collective_bytes

fake_world(8)
mesh = device_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
sh = dict(SHAPES["train_4k"], name="train_4k")
sh["batch"], sh["seq"] = max(2, sh["batch"] // 128), min(sh["seq"], 64)
out = {}
for a in sys.argv[1].split(","):
    spec = get_arch(a)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = _fake_model(spec.smoke_config, "cpu")
        c, arg, arg_port, res = trace_train(spec, model, mesh, _rules_for(spec), sh, "cpu")
    out[a] = {"collectives": collective_bytes(c.records), "argument_bytes": arg,
              "argument_bytes_port": arg_port, "temp_bytes": c.peak, "flops": c.flops,
              "fits_hbm": arg + res + c.peak < H100.hbm_bytes}
with tempfile.TemporaryDirectory() as d:
    out["prefill"] = run_cell("qwen3-0.6b", "prefill_32k", False, d, device="cpu",
                              overrides={"num_layers": 1})
    out["decode"] = run_cell("rwkv6-3b", "long_500k", True, d, device="cpu",
                             overrides={"num_layers": 1})
for r in out.values():
    r.pop("trace", None)
print(json.dumps(out))
"""

# repro.launch.dryrun.lower_train's arguments, their shardings as it builds
# them (its module forces 512 host devices at import, so the lines are
# restated), summed per device
JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, math, sys
import jax, jax.numpy as jnp
from repro.configs import SHAPES, get_arch
from repro.distributed.sharding import (DEFAULT_RULES, FSDP_RULES, Axes, make_mesh_compat,
                                        named_sharding, shard_params_tree)
from repro.models.transformer import Model, shapes_and_axes
from repro.train.optimizer import OptConfig, adamw_init, opt_state_shardings
from repro.train.train_step import batch_shardings

mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"))
out = {}
for a in sys.argv[1].split(","):
    spec = get_arch(a)
    rules = FSDP_RULES if spec.rules == "fsdp" else DEFAULT_RULES
    model = Model(spec.smoke_config)
    opt_cfg = OptConfig(state_bits=spec.opt_bits, master_weights=True)
    shapes, axes = shapes_and_axes(model)
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
                          if s.dtype == jnp.float32 else s, shapes)
    p_shard = shard_params_tree(shapes, axes, mesh, rules)
    o_shapes = jax.eval_shape(lambda p: adamw_init(p, opt_cfg), shapes)
    o_shard = opt_state_shardings(shapes, axes, mesh, rules, opt_cfg)
    batch = spec.input_specs("train_4k", smoke=True)
    b_shard = batch_shardings(batch, mesh, rules)
    rep = named_sharding(Axes(), mesh, rules)
    step = jax.ShapeDtypeStruct((), jnp.int32)
    leaves = jax.tree.leaves((shapes, o_shapes, batch, step))
    shards = jax.tree.leaves((p_shard, o_shard, b_shard, rep))
    assert len(leaves) == len(shards)
    out[a] = sum(math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
                 for s, sh in zip(leaves, shards))
print(json.dumps(out))
"""


def _run(code: str, env: dict) -> dict:
    res = subprocess.run([sys.executable, "-c", code, ",".join(ARCHS)], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": SRC, **env}, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    return _run(PORT, {}), _run(JAX, {"JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("arch", ARCHS)
def test_multipod_trace_smoke(cells, arch):
    port, jax_bytes = cells
    r = port[arch]
    # DP over pod (+data where the batch divides) must produce gradient all-reduces
    assert "all-reduce" in r["collectives"]
    assert r["argument_bytes"] == jax_bytes[arch]
    assert r["argument_bytes_port"] == jax_bytes[arch]
    assert r["temp_bytes"] > 0 and r["flops"] > 0
    assert r["fits_hbm"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_production_mesh_cells(cells, kind):
    r = cells[0][kind]
    assert r["status"] == "ok", r.get("error")
    assert r["kind"] == kind and r["chips"] == (256 if kind == "prefill" else 512)
    m = r["scan_measure"]
    assert m["cost"]["flops"] > 0 and m["memory"]["argument_bytes"] > 0
    assert "all-gather" in m["collectives"]
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
