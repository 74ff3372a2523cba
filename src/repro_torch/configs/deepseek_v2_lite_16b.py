"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H MLA(kv_lora=512) MoE 64e top-6
+ 2 shared, vocab 102400.  [arXiv:2405.04434; hf]

MLA: q heads 16 x (128 nope + 64 rope); v_head 128; kv compressed to 512.
Layer 0 is dense (d_ff 10944), layers 1..26 MoE (expert d_ff 1408).
"""
from repro_torch.models.layers import MLAConfig
from repro_torch.models.transformer import ModelConfig, MoEConfig
from .common import FULL_ATTN_SKIP, ArchSpec

NAME = "deepseek-v2-lite-16b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=27, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=192, d_ff=1408, vocab_size=102400,
        attention="mla",
        mla=MLAConfig(d_model=2048, num_heads=16, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, num_shared=2,
                      shared_d_ff=2816, dispatch="sort"),
        first_dense=1, first_dense_ff=10944,
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=24, d_ff=48, vocab_size=512,
        attention="mla",
        mla=MLAConfig(d_model=64, num_heads=4, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=48, num_shared=2,
                      shared_d_ff=96, dispatch="sort"),
        first_dense=1, first_dense_ff=128,
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, rules="fsdp")
