"""Training launcher: real steps on one device (a card, or the CPU), or
sharded over a host mesh of ``torchrun`` ranks.

The counterpart of ``repro.launch.train``, with its flags and its
``[train]`` lines, on any --arch (the smoke config by default, the
published one with ``--full``): init from a seeded generator, the train
step (chunked loss, backward, global-norm clip, AdamW under the cosine
schedule), the deterministic data pipeline, step-granular checkpointing,
NaN-step rejection (``StepGuard``: a rejected step is never applied, and
too many in a row restore the last checkpoint), and crash/restart
(--inject-failure kills the process after that step with exit code 17;
rerunning with the same --ckpt resumes from its last checkpoint, bit for
bit on the CPU).

  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 50
  python -m repro_torch.launch.train --arch qwen3-0.6b --full --batch 8 --seq 512
  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 --ckpt /tmp/ck \\
      --ckpt-every 4 --device cpu

It runs on the CUDA device unless ``--device cpu``, and raises without a
card. Under ``torchrun`` (a world of more than one rank, or
``--model-parallel`` M > 1) it shards over the (world // M, M)
('data', 'model') host mesh (``launch.mesh.make_host_mesh``): NCCL and one
card a rank (``cuda:LOCAL_RANK``), or gloo with ``--device cpu``; the rules
are FSDP_RULES for an fsdp arch at ``--full``, else DEFAULT_RULES, as the
JAX launcher picks them; the step is ``train_step.ShardedTrainStep``. Every
rank inits the same weights from --seed and keeps its blocks; only rank 0
prints.

  torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.train \
      --arch qwen3-0.6b --model-parallel 2 --steps 5 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.distributed.fault_tolerance import StepGuard
from repro_torch.distributed.sharding import DEFAULT_RULES, FSDP_RULES
from repro_torch.models.transformer import Model
from repro_torch.train.checkpoint import CheckpointManager, assign_
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import ShardedTrainStep, jit_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def zero_extras(spec, cfg, batch: int, seq: int, device) -> dict:
    """The arch's extra inputs (modality stubs), zero-filled on ``device``."""
    if not spec.extras:
        return {}
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in spec.extras("train", cfg, batch, seq).items()}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def say(*a, **k) -> None:
    """print, on rank 0 alone."""
    if _rank() == 0:
        print(*a, **k)


def train_loop(model, opt_cfg: OptConfig, data: SyntheticLMData, steps: int,
               extras: dict | None = None, ckpt: CheckpointManager | None = None,
               ckpt_every: int = 10, inject_failure: int = -1, seed: int = 0,
               mesh=None, rules=DEFAULT_RULES) -> dict:
    """Train ``model`` in place from ``data``'s steps up to ``steps``
    (sharded over ``mesh`` when it has more than one device), resuming from
    ``ckpt``'s latest checkpoint when there is one, printing the JAX
    launcher's lines. Returns {"opt_state", "losses" (the accepted steps'),
    "metrics" (each step's {"loss", "gnorm", "lr"} as floats), "step_seconds"
    (each step's host wall, ended by a synchronize), "rejected", "step_fn"}."""
    device = model.device
    step_fn, _ = jit_train_step(model, mesh, rules, opt_cfg, total_steps=steps)
    sharded = isinstance(step_fn, ShardedTrainStep)
    opt_state = step_fn.init_state() if sharded else adamw_init(model.tree(), opt_cfg)
    start = 0

    def restore():
        placed = dict(mesh=mesh, param_shardings=step_fn.param_shardings,
                      opt_shardings=step_fn.opt_shardings) if sharded else {}
        params, opt, manifest = ckpt.restore(None, model.tree(), opt_state, **placed)
        assign_(model.tree(), params)
        assign_(opt_state, opt)
        return manifest
    if ckpt and ckpt.latest() is not None:
        manifest = restore()
        data.restore(manifest["data_state"])
        start = manifest["step"] + 1
        say(f"[train] restored step {manifest['step']} from {ckpt.dir}")

    guard = StepGuard()
    losses, seconds, history = [], [], []
    for step in range(start, steps):
        hb = data.batch_at(step)
        batch = {k: torch.from_numpy(v).to(device) for k, v in hb.items()}
        batch.update(extras or {})
        t0 = time.perf_counter()
        out = step_fn(opt_state, batch, step)
        metrics = {k: float(v) for k, v in out.items()}
        history.append(metrics)
        if guard.ok(metrics):
            step_fn.apply(opt_state, out)
            losses.append(metrics["loss"])
        else:
            say(f"[train] step {step}: REJECTED (loss={metrics['loss']}, "
                f"gnorm={metrics['gnorm']})")
            if guard.should_restore and ckpt:
                say("[train] too many rejections — restoring checkpoint")
                restore()
        _sync(device)
        dt = time.perf_counter() - t0
        seconds.append(dt)
        say(f"[train] step {step} loss={metrics['loss']:.4f} "
            f"gnorm={metrics['gnorm']:.3f} lr={metrics['lr']:.2e} "
            f"{dt*1000:.0f}ms", flush=True)
        if ckpt and (step + 1) % ckpt_every == 0:
            data.step = step
            ckpt.save(step, model.tree(), opt_state, data.state())
        if step == inject_failure:
            say("[train] injected failure — killing process", flush=True)
            os._exit(17)
    if ckpt:
        ckpt.save(steps - 1, model.tree(), opt_state, {"step": steps - 1, "seed": seed})
    say("[train] done")
    return {"opt_state": opt_state, "losses": losses, "metrics": history,
            "step_seconds": seconds, "rejected": guard.rejected, "step_fn": step_fn}


def _init_world(device: str, model_parallel: int):
    """(the host mesh, this rank's device, whether this call started the
    process group): the ``torchrun`` world (NCCL on cuda, gloo on the CPU),
    or a group the caller started, or (None, device, False) outside both
    with --model-parallel 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and model_parallel == 1 and not dist.is_initialized():
        return None, device, False
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl" if device.startswith("cuda") else "gloo")
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model_parallel, torch.device(device).type), device, started


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published config (qwen3-0.6b fits one card); default: smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="crash after this step (restart demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same steps on the CPU)")
    args = ap.parse_args(argv)
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world % args.model_parallel:
        ap.error(f"--model-parallel {args.model_parallel} wants a world of a multiple of "
                 f"{args.model_parallel} ranks (torchrun --nproc_per_node), have {world}")

    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke_config
    mesh, device, started = _init_world(args.device, args.model_parallel)
    rules = FSDP_RULES if (spec.rules == "fsdp" and args.full) else DEFAULT_RULES
    model = Model(cfg, device=device, generator=torch.Generator().manual_seed(args.seed))
    opt_cfg = OptConfig(lr=args.lr, state_bits=spec.opt_bits if args.full else 32)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    out = train_loop(model, opt_cfg, data, args.steps,
                     zero_extras(spec, cfg, args.batch, args.seq, model.device),
                     CheckpointManager(args.ckpt) if args.ckpt else None,
                     args.ckpt_every, args.inject_failure, args.seed, mesh, rules)
    if started:
        dist.destroy_process_group()
    return {"model": model, **out}


if __name__ == "__main__":
    main()
