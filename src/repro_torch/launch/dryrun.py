"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step once on
fake tensors over a fake world.

The counterpart of ``repro.launch.dryrun``. Where the JAX package forces
512 host devices at import and lowers and compiles each cell, the port
starts a ``fake`` process group (``torch.testing``'s ``FakeStore``) of the
mesh's size inside ``run_cell`` / ``main`` (never at import), builds the
production mesh on it as a ``DeviceMesh``, and runs the cell's step once
under ``FakeTensorMode`` (tensors with shapes, dtypes and devices and no
data; on ``cuda`` unless ``device="cpu"``) inside a ``CostCounter``:

  memory  argument_bytes: the bytes one device holds of the step's
          arguments under the JAX layout's shardings (``shardings_for``,
          ``batch_shardings``: stacked units, as the JAX step's), equal to
          XLA's ``argument_size_in_bytes``; argument_bytes_port: the same
          for the port's per-unit leaves (they differ where ZeRO shards a
          stacked leaf's unit axis); temp_bytes: the high-water mark of the
          live bytes the step's local ops allocate; output_bytes: the
          metrics (parameters and state are updated in place, so nothing
          aliases); peak_bytes = argument + output + temp
  cost    flops (matrix products) and bytes (every op's tensor inputs and
          outputs, unfused) of each rank's local ops: per device
  collectives  result bytes of each c10d functional collective, by the
          JAX package's HLO op names

``fits_hbm`` holds the peak against ``HW.hbm_bytes`` (one H100, 80 GB).
The JAX scan calibration (``_calib_config``, ``_combine``) corrects XLA's
count of a scan body, which it counts once; the port's units are a Python
list, each dispatched and counted, so ``calib_measure`` is None. The step
is ``train_step.ShardedTrainStep``'s: data parallel over the dimensions
the batch is sharded on, tensor parallel over 'model' (each rank its share
of the heads, d_ff, experts and vocabulary, where they split) with every
other parameter gathered whole at its use. A prefill cell runs the same
forward. A decode cell gathers every parameter whole (the 'model' axis
shards its storage, and the caches' sequence, not its compute). The
numbers are this program's, not XLA's partitioned one's: where a dimension
does not split over 'model' (qwen3-0.6b's 8 kv heads on 16), this step
computes it whole on each rank, which XLA may partition otherwise.

Artifacts land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.configs.common import ArchSpec
from repro_torch.distributed.sharding import (DEFAULT_RULES, FSDP_RULES, Axes, data_parallel,
                                              distribute, is_axes, mesh_context, named_sharding,
                                              shard_params_tree, tensor_parallel)
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, device_mesh, mesh_chips
from repro_torch.models.transformer import Model, shapes_and_axes
from repro_torch.roofline.analysis import (H100, CostCounter, collective_bytes,
                                           model_flops_6nd, roofline_report)
from repro_torch.train.optimizer import OptConfig, adamw_init, tree_leaves
from repro_torch.train.train_step import (ShardedTrainStep, _param_slots, _reshard,
                                          batch_shardings, shardings_for, tree_shard_bytes)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _rules_for(spec: ArchSpec):
    return FSDP_RULES if spec.rules == "fsdp" else DEFAULT_RULES


def fake_world(size: int) -> None:
    """A ``fake`` default process group of ``size`` ranks, this process rank
    0 (any other default group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _bf16(shapes):
    """Params ride bf16 on the wire/HBM; the fp32 master lives (ZeRO-
    sharded) in the optimizer state."""
    def one(t):
        return t.to(torch.bfloat16) if t.dtype == torch.float32 else t
    if isinstance(shapes, dict):
        return {k: _bf16(v) for k, v in shapes.items()}
    return one(shapes)


def _cache_shapes_and_axes(model: Model, batch: int, max_len: int):
    """(cache tree, Axes tree) of ``model`` (on ``meta``: nothing allocated)."""
    caches, axes = model.init_cache(batch, max_len)
    if model.cfg.first_dense:
        d, da = model.init_dense_cache(batch, max_len)
        caches["dense"], axes["dense"] = d, da
    return caches, axes


def _active_params(model: Model) -> tuple[int, int]:
    """(total, active) parameter counts (active discounts unrouted experts,
    identified by the 'experts' logical axis)."""
    cfg = model.cfg
    shapes, axes = shapes_and_axes(model)
    flat_s = tree_leaves(shapes)
    flat_a = [a for a in _axes_leaves(axes)]
    total = sum(math.prod(s.shape) for s in flat_s)
    if cfg.moe is None:
        return total, total
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    expert = sum(math.prod(s.shape) for s, a in zip(flat_s, flat_a) if "experts" in a)
    active = total - int(expert * (1 - k / E))
    return total, active


def _axes_leaves(tree):
    if is_axes(tree):
        return [tree]
    return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]


# ---------------------------------------------------------------------------
# per-kind tracing
# ---------------------------------------------------------------------------


def _meta_model(cfg) -> Model:
    """``cfg``'s model on ``meta`` (built outside any FakeTensorMode)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return Model(cfg, device="meta")


def _fake_model(cfg, device: str) -> Model:
    """``cfg``'s model with bfloat16 fake parameters on ``device`` (call
    under FakeTensorMode)."""
    model = _meta_model(cfg)
    for owner, leaf, _ in _param_slots(model):
        p = owner._parameters[leaf]
        owner._parameters[leaf] = torch.nn.Parameter(
            torch.empty(p.shape, dtype=torch.bfloat16, device=device))
    return model


def _fake_like(t, device: str):
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes
               for t in tree_leaves(tree))


def trace_train(spec: ArchSpec, model: Model, mesh, rules, shape_spec, device: str):
    opt_cfg = OptConfig(state_bits=spec.opt_bits, master_weights=True)
    shapes, axes = shapes_and_axes(model)
    p_shard, o_shard, _, _ = shardings_for(model, mesh, rules, opt_cfg)
    batch_spec = spec.input_specs_for(model.cfg, shape_spec)
    b_shard = batch_shardings(batch_spec, mesh, rules)
    o_shapes = adamw_init(_bf16(shapes), opt_cfg)          # meta tensors
    arg = (tree_shard_bytes(_bf16(shapes), p_shard) + tree_shard_bytes(o_shapes, o_shard)
           + tree_shard_bytes(batch_spec, b_shard) + 4)         # + the step (int32)
    step = ShardedTrainStep(model, mesh, rules, opt_cfg)
    opt = step.init_state()
    batch = step.shard_batch({k: _fake_like(v, device) for k, v in batch_spec.items()})
    arg_port = (_local_bytes(model.tree()) + _local_bytes(opt) + _local_bytes(batch) + 4)
    with CostCounter() as c:
        metrics = step(opt, batch, 0)
        step.apply(opt, metrics)
    out = sum(t.nbytes for t in metrics.values())
    return c, arg, arg_port, out


def trace_prefill(spec: ArchSpec, model: Model, mesh, rules, shape_spec, device: str):
    shapes, axes = shapes_and_axes(model)
    p_shard = shard_params_tree(_bf16(shapes), axes, mesh, rules)
    batch_spec = spec.input_specs_for(model.cfg, shape_spec)
    batch_spec.pop("targets", None)
    b_shard = batch_shardings(batch_spec, mesh, rules)
    arg = tree_shard_bytes(_bf16(shapes), p_shard) + tree_shard_bytes(batch_spec, b_shard)
    step = ShardedTrainStep(model, mesh, rules)
    batch = step.shard_batch({k: _fake_like(v, device) for k, v in batch_spec.items()})
    arg_port = _local_bytes(model.tree()) + _local_bytes(batch)
    local = {k: v.to_local() for k, v in batch.items()}
    with CostCounter() as c, torch.no_grad():
        with (data_parallel(step.data_parallel(batch)), tensor_parallel(step.tp),
              mesh_context(mesh, rules)):
            x, _ = model.apply_hidden(local)
            logits = model._logits(x[:, -1:])[:, 0]       # the last position's
    return c, arg, arg_port, logits.nbytes


def trace_decode(spec: ArchSpec, model: Model, mesh, rules, shape_spec, device: str):
    cfg = model.cfg
    B, S = shape_spec["batch"], shape_spec["seq"]
    shapes, axes = shapes_and_axes(model)
    p_shard = shard_params_tree(_bf16(shapes), axes, mesh, rules)
    c_shapes, c_axes = _cache_shapes_and_axes(_meta_model(cfg), B, S)
    c_shard = shard_params_tree(c_shapes, c_axes, mesh, rules)
    tok_shard = named_sharding(Axes("batch", None), mesh, rules, (B, 1))
    arg = (tree_shard_bytes(_bf16(shapes), p_shard) + tree_shard_bytes(c_shapes, c_shard)
           + math.prod(tok_shard.shard_shape((B, 1))) * 4 + 4)   # tokens, pos
    enc_args = []
    if cfg.encoder_layers:
        se = min(4096, S)
        e_sh = named_sharding(Axes("batch", "seq", "embed"), mesh, rules, (B, se, cfg.d_model))
        ep_sh = named_sharding(Axes("batch", "seq"), mesh, rules, (B, se))
        arg += (math.prod(e_sh.shard_shape((B, se, cfg.d_model))) * cfg.dtype.itemsize
                + math.prod(ep_sh.shard_shape((B, se))) * 4)
        enc_args = [distribute(torch.zeros((B, se, cfg.d_model), dtype=cfg.dtype, device=device),
                               e_sh),
                    distribute(torch.zeros((B, se), dtype=torch.int32, device=device), ep_sh)]
    step = ShardedTrainStep(model, mesh, rules)
    caches = _map(lambda t, sh: distribute(_fake_like(t, device), sh), c_shapes, c_shard)
    token = distribute(torch.zeros((B, 1), dtype=torch.int32, device=device), tok_shard)
    arg_port = (_local_bytes(model.tree()) + _local_bytes(caches) + _local_bytes(token) + 4
                + sum(e.to_local().nbytes for e in enc_args))
    dp = step.data_parallel({"tokens": token})

    def batch_only(t, axes):
        """``t``'s placements with every shard but its batch dimension's
        gathered (the caches' sequence blocks: each rank decodes its
        sequences against their whole caches)."""
        from torch.distributed.tensor import Replicate, Shard
        return [pl if isinstance(pl, Shard) and pl.dim == list(axes).index("batch")
                and name in dp.dims else Replicate()
                for name, pl in zip(mesh.mesh_dim_names, t.placements)]

    def put(t, axes, block):
        new = DTensor.from_local(block, mesh, batch_only(t, axes))
        t.to_local().copy_(_reshard(new, t.placements).to_local())

    from torch.distributed.tensor import DTensor
    with CostCounter() as c, torch.no_grad():
        local = _map(lambda t, a: _reshard(t, batch_only(t, a)).to_local(), caches, c_axes)
        enc_local = [e.to_local() for e in enc_args]
        with data_parallel(dp), mesh_context(mesh, rules):
            # writes the local caches in place
            logits, _ = model.decode_step(token.to_local(), S - 1, local, *enc_local)
        _map(put, caches, c_axes, local)
    return c, arg, arg_port, logits.nbytes


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


LOWER = {"train": trace_train, "prefill": trace_prefill, "decode": trace_decode}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _measure(c: CostCounter, arg: int, arg_port: int, out: int, label: str, dt: float) -> dict:
    mem = {"argument_bytes": int(arg), "argument_bytes_port": int(arg_port),
           "output_bytes": int(out), "temp_bytes": int(c.peak), "alias_bytes": 0,
           "code_bytes": 0}
    mem["peak_bytes"] = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    return {"label": label, "compile_s": dt, "ops": c.ops,
            "cost": {"flops": float(c.flops), "bytes": float(c.bytes)},
            "memory": mem, "collectives": collective_bytes(c.records)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, overrides: dict | None = None, *,
             device: str = "cuda") -> dict:
    """One cell's record (also written as JSON under ``out_dir``). The JAX
    signature's ``calibrate`` has no counterpart: there is nothing to
    calibrate (see the module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec = get_arch(arch)
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    reason = spec.skips.get(shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "device": device,
              "time": time.time()}
    if reason:
        record.update({"status": "skipped", "reason": reason})
        json.dump(record, open(path, "w"), indent=1)
        return record

    sh = dict(SHAPES[shape_name])
    sh["name"] = shape_name
    cfg = spec.config
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    kind = sh["kind"]
    try:
        fake_world(math.prod(shape))
        mesh = device_mesh(shape, names, torch.device(device).type)
        rules = _rules_for(spec)
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True):
            model = _fake_model(cfg, device)
            c, arg, arg_port, out = LOWER[kind](spec, model, mesh, rules, sh, device)
        scan_m = _measure(c, arg, arg_port, out, "trace", time.perf_counter() - t0)
        chips = mesh_chips(mesh)
        total, active = _active_params(model)
        if kind == "train":
            mf = model_flops_6nd(total, sh["batch"] * sh["seq"], active)
        elif kind == "prefill":
            mf = model_flops_6nd(total, sh["batch"] * sh["seq"], active) / 3.0   # fwd only
        else:
            mf = model_flops_6nd(total, sh["batch"], active) / 3.0
        combined = {"flops": scan_m["cost"]["flops"], "bytes": scan_m["cost"]["bytes"],
                    "collectives": scan_m["collectives"]}
        roof = roofline_report(combined["flops"], combined["bytes"], combined["collectives"],
                               chips, model_flops=mf)
        record.update({
            "status": "ok", "kind": kind, "chips": chips, "lower_s": scan_m["compile_s"],
            "params_total": total, "params_active": active, "units": cfg.num_units,
            "scan_measure": scan_m, "calib_measure": None,
            "combined": combined, "roofline": roof,
            "fits_hbm": scan_m["memory"]["peak_bytes"] < H100.hbm_bytes,
        })
    except Exception as e:  # record the failure — dry-run bugs are bugs
        record.update({"status": "error", "error": repr(e),
                       "trace": traceback.format_exc()})
    json.dump(record, open(path, "w"), indent=1)
    return record


def _line(r: dict) -> str:
    status = r.get("status")
    extra = ""
    if status == "ok":
        roof = r["roofline"]
        extra = (f" dominant={roof['dominant']} "
                 f"peakGB={r['scan_measure']['memory']['peak_bytes']/1e9:.2f} "
                 f"fit={r['fits_hbm']}")
    elif status == "error":
        extra = " " + r["error"][:120]
    return f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: {status}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default cuda; cpu on a host with no card)")
    from repro_torch.launch.cli import add_out_args
    add_out_args(ap, default_out=OUT_DIR)
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:          # every arch, at --shape alone when it is given
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES if s == (args.shape or s)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    if len(meshes) > 1:
        # a fake world has one size: each mesh in a process of its own
        for m in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", m,
                   "--device", args.device, "--out", args.out]
            cmd += (["--all"] + (["--shape", args.shape] if args.shape else [])
                    if args.all else ["--arch", args.arch, "--shape", args.shape])
            cmd += ["--force"] if args.force else []
            rc = subprocess.run(cmd).returncode
            if rc:
                return rc
        return 0
    for a, s in cells:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            path = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
            if not args.force and os.path.exists(path):
                prev = json.load(open(path))
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {a} {s} {mesh_name}: cached ({prev['status']})", flush=True)
                    continue
            print(_line(run_cell(a, s, mp, args.out, device=args.device)), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
