"""qwen3-moe-235b-a22b [moe] — 94L d=4096 64H (kv=4) moe_ff=1536, 128e top-8,
vocab 151936, qk_norm.  [hf:Qwen/Qwen3-235B-A22B; hf]
"""
from repro_torch.models.transformer import ModelConfig, MoEConfig
from .common import FULL_ATTN_SKIP, ArchSpec

NAME = "qwen3-moe-235b-a22b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=94, d_model=4096, num_heads=64,
        num_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
        qk_norm=True, kv_repeat=4, rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536, dispatch="sort"),
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
        qk_norm=True, kv_repeat=2,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, dispatch="sort"),
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, rules="fsdp",
                    opt_bits=8)
