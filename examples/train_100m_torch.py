"""End-to-end training, on the PyTorch/CUDA port: train a ~100M-param
qwen3-style model for a few hundred steps on the synthetic bigram corpus and
watch the loss fall well below the unigram entropy — the full loop (seeded
init, the train step with the chunked loss, checkpointing, NaN guard) on one
device.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]   # on the card
  PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 2 --batch 2 --seq 16

The counterpart of ``examples/train_100m.py``: the same config, data and
optimizer, and the same lines, through ``repro_torch`` alone, but for one
field: the JAX example's ``kv_repeat=2`` puts its 12 query heads over 4 x 2
KV heads, which 12 does not divide, and its first step fails reshaping them
(``(B, S, 12, 64)`` into ``(B, S, 8, 1, 64)``). ``kv_repeat`` only replicates
KV heads for tensor parallelism; here it is 1, each KV head serving 3 query
heads (what ``kv_repeat=3`` would compute too). The parameter count is the
JAX config's. Checkpoints go to --ckpt every 100 steps (default: a temporary
directory, removed at the end).
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import math
import tempfile

import torch

from repro_torch.distributed.fault_tolerance import StepGuard
from repro_torch.models.transformer import Model, ModelConfig, param_count
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same steps on the CPU)")
    args = ap.parse_args()

    cfg = ModelConfig(name="qwen3-100m", num_layers=10, d_model=768,
                      num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2560,
                      vocab_size=32768, qk_norm=True, tie_embeddings=True,
                      kv_repeat=1)
    model = Model(cfg, device=args.device)
    print(f"[100m] params: {param_count(model)/1e6:.1f}M")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=1, noise=0.05)
    opt_cfg = OptConfig(lr=1e-3)
    step_fn = make_train_step(model, opt_cfg, total_steps=args.steps)
    opt = adamw_init(model.tree(), opt_cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(args.ckpt or tmp)
        guard = StepGuard()
        unigram_entropy = math.log(cfg.vocab_size)
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in data.batch_at(step).items()}
            out = step_fn(opt, batch, step)
            metrics = {k: float(v) for k, v in out.items()}
            if guard.ok(metrics):
                step_fn.apply(opt, out)
            if step % 25 == 0 or step == args.steps - 1:
                print(f"[100m] step {step:4d} loss={metrics['loss']:.4f} "
                      f"(unigram entropy {unigram_entropy:.2f})", flush=True)
            if (step + 1) % 100 == 0:
                ckpt.save(step, model.tree(), opt, data.state())
    final = float(metrics["loss"])
    print(f"[100m] final loss {final:.3f} vs unigram {unigram_entropy:.2f} "
          f"-> {'LEARNED structure' if final < unigram_entropy - 1 else 'check hyperparams'}")


if __name__ == "__main__":
    main()
