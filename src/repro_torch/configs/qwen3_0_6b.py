"""qwen3-0.6b [dense] — 28L d=1024 16H (kv=8) d_ff=3072 vocab=151936,
qk_norm, tied embeddings.  [hf:Qwen/Qwen3-0.6B; hf]
"""
from repro_torch.models.transformer import ModelConfig
from .common import FULL_ATTN_SKIP, ArchSpec

NAME = "qwen3-0.6b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=28, d_model=1024, num_heads=16,
        num_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151936,
        qk_norm=True, tie_embeddings=True, kv_repeat=2, rope_theta=1e6,
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        qk_norm=True, tie_embeddings=True, kv_repeat=2,
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP})
