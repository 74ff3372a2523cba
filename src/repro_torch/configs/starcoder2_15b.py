"""starcoder2-15b [dense] — 40L d=6144 48H (kv=4) d_ff=24576 vocab=49152,
GQA + RoPE, LayerNorm.  [arXiv:2402.19173; hf]
"""
from repro_torch.models.transformer import ModelConfig
from .common import FULL_ATTN_SKIP, ArchSpec

NAME = "starcoder2-15b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=40, d_model=6144, num_heads=48,
        num_kv_heads=4, head_dim=128, d_ff=24576, vocab_size=49152,
        kv_repeat=4, norm="layernorm", act="gelu", rope_theta=1e5,
        gated_mlp=False,
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512,
        kv_repeat=2, norm="layernorm", act="gelu", gated_mlp=False,
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, rules="fsdp")
