"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

from importlib import import_module

from .common import SHAPES, ArchSpec

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-0.6b": "qwen3_0_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = list(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_NAMES}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").spec()


def all_cells():
    """Every (arch, shape) pair with skip reasons resolved."""
    for name in ARCH_NAMES:
        s = get_arch(name)
        for shape in SHAPES:
            yield name, shape, s.skips.get(shape)


__all__ = ["get_arch", "all_cells", "ARCH_NAMES", "SHAPES", "ArchSpec"]
