"""The one-device train step: forward, backward, global norm and schedule,
then the AdamW update in place once the caller has accepted the step.

The counterpart of ``repro.train.train_step``'s ``make_train_step`` and
``lr_schedule``. The JAX step returns new (params, opt_state) trees and its
launcher keeps the old ones alive until ``StepGuard`` accepts the metrics;
the port's model and state are updated in place, so the step is split in
two: ``step(opt_state, batch, step)`` leaves the grads on the parameters and
returns the metrics, and ``step.apply(opt_state, metrics)`` updates. A step
the guard rejects is never applied: parameters, moments and count stay as
they were. The sharded step (``shardings_for``, ``batch_shardings``,
``jit_train_step``) waits for the LM partition rules.
"""
from __future__ import annotations

import math

import torch

from .optimizer import OptConfig, adamw_apply_, global_norm, tree_leaves, tree_map


def lr_schedule(step, base_lr: float, warmup: int = 100,
                total: int = 10_000, min_frac: float = 0.1, device=None):
    """Linear warmup then cosine decay to ``min_frac``, in float32 (a 0-d
    tensor on ``device``), as XLA computes the JAX package's."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


class TrainStep:
    """``model``'s train step under ``opt_cfg`` and the schedule of
    ``total_steps``. Call it for the metrics, then ``apply`` them."""

    def __init__(self, model, opt_cfg: OptConfig = OptConfig(), total_steps: int = 10_000):
        self.model = model
        self.opt_cfg = opt_cfg
        self.total_steps = total_steps

    def __call__(self, opt_state: dict, batch: dict, step) -> dict:
        """``model.loss(batch)`` and its grads, left on the parameters (those
        of the previous step dropped first): {"loss", "gnorm", "lr"}, float32
        0-d tensors on the model's device. Nothing is updated."""
        model = self.model
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        gnorm = global_norm(tree_leaves(self._grads()))
        lr = lr_schedule(step, self.opt_cfg.lr, total=self.total_steps, device=model.device)
        return {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}

    def _grads(self):
        # a parameter the loss does not reach has a zero gradient, as in JAX
        return tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                        self.model.tree())

    def apply(self, opt_state: dict, metrics: dict) -> None:
        """The AdamW update of the step that gave ``metrics``, in place on the
        model's parameters and ``opt_state``; the grads are dropped after."""
        adamw_apply_(self.model.tree(), self._grads(), opt_state, metrics["lr"],
                     metrics["gnorm"], self.opt_cfg)
        self.model.zero_grad(set_to_none=True)


def make_train_step(model, opt_cfg: OptConfig = OptConfig(),
                    total_steps: int = 10_000) -> TrainStep:
    """The one-device train step of ``model`` (see ``TrainStep``)."""
    return TrainStep(model, opt_cfg, total_steps)
