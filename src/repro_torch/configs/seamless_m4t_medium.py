"""seamless-m4t-medium [audio] — enc-dec 12L+12L d=1024 16H (kv=16)
d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

Frontend stub per assignment: ``input_specs`` provides precomputed audio
frame embeddings (B, S_enc, d_model). Vocab is padded 256206 -> 256256
(multiple of 256) for sharding — standard embedding padding, noted in
EXPERIMENTS.md.
"""
import torch

from repro_torch.models.transformer import ModelConfig
from .common import FULL_ATTN_SKIP, ArchSpec, spec_tensor

NAME = "seamless-m4t-medium"
VOCAB_PAD = 256256   # 256206 padded to /256
ENC_FRAMES = 4096    # encoder frames for decode shapes


def _extras(shape_name, cfg, B, S):
    se = min(ENC_FRAMES, S) if shape_name.startswith(("decode", "long")) else S
    return {"frames": spec_tensor((B, se, cfg.d_model), torch.bfloat16)}


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=12, d_model=1024, num_heads=16,
        num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=VOCAB_PAD,
        encoder_layers=12, frontend="audio", act="gelu", gated_mlp=False,
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_layers=2, frontend="audio", act="gelu", gated_mlp=False,
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, extras=_extras)
