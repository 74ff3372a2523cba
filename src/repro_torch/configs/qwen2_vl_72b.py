"""qwen2-vl-72b [vlm] — 80L d=8192 64H (kv=8) d_ff=29568 vocab=152064,
M-RoPE (t/h/w sections 16/24/24 of head_dim/2), dynamic-resolution vision.
[arXiv:2409.12191; hf]

Per assignment, the modality frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, n_patches, d_model) merged at the sequence
head, plus the 3-stream M-RoPE position ids.
"""
import torch

from repro_torch.models.transformer import ModelConfig
from .common import FULL_ATTN_SKIP, ArchSpec, spec_tensor

NAME = "qwen2-vl-72b"
N_PATCHES = 1024      # frontend stub: patches per sample in train/prefill


def _extras(shape_name, cfg, B, S):
    if shape_name.startswith("decode") or shape_name.startswith("long"):
        return {"mrope_positions": spec_tensor((3, B, 1), torch.int32)}
    n = min(N_PATCHES, S // 2)
    return {
        "input_embeds": spec_tensor((B, n, cfg.d_model), torch.bfloat16),
        "mrope_positions": spec_tensor((3, B, S), torch.int32),
    }


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=80, d_model=8192, num_heads=64,
        num_kv_heads=8, head_dim=128, d_ff=29568, vocab_size=152064,
        kv_repeat=2, mrope_sections=(16, 24, 24), rope_theta=1e6,
        frontend="vision",
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        kv_repeat=2, mrope_sections=(4, 2, 2), frontend="vision",
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, rules="fsdp",
                    opt_bits=8, extras=_extras)
