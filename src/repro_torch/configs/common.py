"""Shared shape grid + ArchSpec plumbing for the assigned architectures.

The counterpart of ``repro.configs.common``. Every arch module exports
``spec() -> ArchSpec`` with:
  config        the full published configuration (counted on the ``meta``
                device; qwen3-0.6b is small enough to run on one card)
  smoke_config  a reduced same-family config for CPU tests
  skips         {shape_name: reason} — e.g. long_500k on full-attention
  extras(shape) additional inputs as ``meta`` tensors (modality stubs),
                where the JAX package gives ``jax.ShapeDtypeStruct``s

Shape grid (assignment): train_4k / prefill_32k / decode_32k / long_500k.
``decode_*``/``long_*`` lower ``serve_step`` (1 new token against a KV/state
cache of seq_len); ``prefill_32k`` lowers the forward pass at full length.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.transformer import Model, ModelConfig

SHAPES: dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

FULL_ATTN_SKIP = "pure full-attention arch: 500k decode cache/step budget " \
    "requires sub-quadratic family (see DESIGN.md §Arch-applicability)"


def spec_tensor(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no data: a tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    config: ModelConfig
    smoke_config: ModelConfig
    skips: dict
    rules: str = "default"              # 'default' | 'fsdp'
    opt_bits: int = 32                  # 8 => int8 optimizer state
    extras: Callable | None = None      # (shape_name, cfg, B, S) -> dict of meta tensors

    def model(self, smoke: bool = False, device="cuda",
              generator: torch.Generator | None = None) -> Model:
        return Model(self.smoke_config if smoke else self.config, device=device,
                     generator=generator)

    def input_specs_for(self, cfg, sh: dict) -> dict:
        """``meta`` tensor stand-ins for a shape dict (see SHAPES)."""
        B, S = sh["batch"], sh["seq"]
        name = sh.get("name", "")
        if sh["kind"] in ("train", "prefill"):
            spec = {
                "tokens": spec_tensor((B, S), torch.int32),
                "targets": spec_tensor((B, S), torch.int32),
            }
            if self.extras:
                spec.update(self.extras(name, cfg, B, S))
            return spec
        # decode: one token; caches/encoder states are built by the launcher
        return {"tokens": spec_tensor((B, 1), torch.int32)}

    def input_specs(self, shape_name: str, smoke: bool = False) -> dict:
        """``meta`` tensor stand-ins for every model input of this cell."""
        cfg = self.smoke_config if smoke else self.config
        sh = dict(SHAPES[shape_name])
        sh["name"] = shape_name
        if smoke:
            sh["batch"] = max(2, sh["batch"] // 128)
            sh["seq"] = min(sh["seq"], 64)
        return self.input_specs_for(cfg, sh)


def smoke_shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
