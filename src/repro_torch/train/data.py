"""Deterministic synthetic data pipeline (no external corpora offline).

Checkpointable by construction: every batch is a pure function of
(seed, step), so the pipeline "state" is a single integer that rides in the
checkpoint manifest. Restart/elastic-reshard resumes bit-exactly, and any
host can generate any shard (straggler work reassignment is trivial).

The token stream has learnable structure (noisy affine bigram chain) so the
end-to-end example's loss demonstrably falls below the unigram entropy.
"""
from __future__ import annotations

import dataclasses

import torch

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    step: int = 0                      # pipeline state (checkpointed)

    def batch_at(self, step: int) -> dict:
        """Pure: batch for a given step (host numpy, device-put by caller)."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        a = 31 % V or 1
        c = 17 % V
        x = np.empty((B, S + 1), dtype=np.int64)
        x[:, 0] = rng.integers(0, V, size=B)
        noise_mask = rng.random((B, S)) < self.noise
        noise_tok = rng.integers(0, V, size=(B, S))
        for t in range(1, S + 1):
            nxt = (x[:, t - 1] * a + c) % V
            x[:, t] = np.where(noise_mask[:, t - 1], noise_tok[:, t - 1], nxt)
        return {"tokens": x[:, :-1].astype(np.int32),
                "targets": x[:, 1:].astype(np.int32)}

    def __iter__(self):
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])


def input_spec_batch(vocab_size: int, seq_len: int, global_batch: int,
                     extras: dict | None = None) -> dict:
    """``meta`` tensor stand-ins for the dry-run (no allocation)."""
    spec = {
        "tokens": torch.empty((global_batch, seq_len), dtype=torch.int32, device="meta"),
        "targets": torch.empty((global_batch, seq_len), dtype=torch.int32, device="meta"),
    }
    if extras:
        spec.update(extras)
    return spec
