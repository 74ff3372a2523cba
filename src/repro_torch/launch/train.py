"""Training launcher: real steps on one device (a card, or the CPU).

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
card. ``--model-parallel`` other than 1 is refused: the JAX launcher shards
over a host mesh whose LM partition rules are not ported (ROADMAP §1.4.2).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.distributed.fault_tolerance import StepGuard
from repro_torch.models.transformer import Model
from repro_torch.train.checkpoint import CheckpointManager, assign_
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def zero_extras(spec, cfg, batch: int, seq: int, device) -> dict:
    """The arch's extra inputs (modality stubs), zero-filled on ``device``."""
    if not spec.extras:
        return {}
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in spec.extras("train", cfg, batch, seq).items()}


def train_loop(model, opt_cfg: OptConfig, data: SyntheticLMData, steps: int,
               extras: dict | None = None, ckpt: CheckpointManager | None = None,
               ckpt_every: int = 10, inject_failure: int = -1, seed: int = 0) -> dict:
    """Train ``model`` in place from ``data``'s steps up to ``steps``,
    resuming from ``ckpt``'s latest checkpoint when there is one, printing
    the JAX launcher's lines. Returns {"opt_state", "losses" (the accepted
    steps'), "step_seconds" (each step's host wall, ended by a synchronize),
    "rejected"}."""
    device = model.device
    step_fn = make_train_step(model, opt_cfg, total_steps=steps)
    opt_state = adamw_init(model.tree(), opt_cfg)
    start = 0

    def restore():
        params, opt, manifest = ckpt.restore(None, model.tree(), opt_state)
        assign_(model.tree(), params)
        assign_(opt_state, opt)
        return manifest
    if ckpt and ckpt.latest() is not None:
        manifest = restore()
        data.restore(manifest["data_state"])
        start = manifest["step"] + 1
        print(f"[train] restored step {manifest['step']} from {ckpt.dir}")

    guard = StepGuard()
    losses, seconds = [], []
    for step in range(start, steps):
        hb = data.batch_at(step)
        batch = {k: torch.from_numpy(v).to(device) for k, v in hb.items()}
        batch.update(extras or {})
        t0 = time.perf_counter()
        out = step_fn(opt_state, batch, step)
        metrics = {k: float(v) for k, v in out.items()}
        if guard.ok(metrics):
            step_fn.apply(opt_state, out)
            losses.append(metrics["loss"])
        else:
            print(f"[train] step {step}: REJECTED (loss={metrics['loss']}, "
                  f"gnorm={metrics['gnorm']})")
            if guard.should_restore and ckpt:
                print("[train] too many rejections — restoring checkpoint")
                restore()
        _sync(device)
        dt = time.perf_counter() - t0
        seconds.append(dt)
        print(f"[train] step {step} loss={metrics['loss']:.4f} "
              f"gnorm={metrics['gnorm']:.3f} lr={metrics['lr']:.2e} "
              f"{dt*1000:.0f}ms", flush=True)
        if ckpt and (step + 1) % ckpt_every == 0:
            data.step = step
            ckpt.save(step, model.tree(), opt_state, data.state())
        if step == inject_failure:
            print("[train] injected failure — killing process", flush=True)
            os._exit(17)
    if ckpt:
        ckpt.save(steps - 1, model.tree(), opt_state, {"step": steps - 1, "seed": seed})
    print("[train] done")
    return {"opt_state": opt_state, "losses": losses, "step_seconds": seconds,
            "rejected": guard.rejected}


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
    if args.model_parallel != 1:
        ap.error("--model-parallel shards over a mesh whose LM partition rules are not "
                 "ported yet (ROADMAP §1.4.2); the port trains on one device")

    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke_config
    model = Model(cfg, device=args.device, generator=torch.Generator().manual_seed(args.seed))
    opt_cfg = OptConfig(lr=args.lr, state_bits=spec.opt_bits if args.full else 32)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    out = train_loop(model, opt_cfg, data, args.steps,
                     zero_extras(spec, cfg, args.batch, args.seq, model.device),
                     CheckpointManager(args.ckpt) if args.ckpt else None,
                     args.ckpt_every, args.inject_failure, args.seed)
    return {"model": model, **out}


if __name__ == "__main__":
    main()
