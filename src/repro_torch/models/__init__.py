"""The LM: one model skeleton for the ten architectures (``transformer``),
its blocks (``layers``, ``moe``, ``mamba``, ``rwkv``) and ``convert``, which
carries the JAX package's parameters across."""
from .transformer import Model, ModelConfig, MoEConfig
from . import convert, layers, moe, mamba, rwkv

__all__ = ["Model", "ModelConfig", "MoEConfig", "convert", "layers", "moe", "mamba", "rwkv"]
