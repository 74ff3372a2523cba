"""stablelm-12b [dense] — 40L d=5120 32H (kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b; hf]
"""
from repro_torch.models.transformer import ModelConfig
from .common import FULL_ATTN_SKIP, ArchSpec

NAME = "stablelm-12b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=40, d_model=5120, num_heads=32,
        num_kv_heads=8, head_dim=160, d_ff=13824, vocab_size=100352,
        kv_repeat=2, norm="layernorm",
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        kv_repeat=2, norm="layernorm",
    )
    return ArchSpec(NAME, full, smoke,
                    skips={"long_500k": FULL_ATTN_SKIP}, rules="fsdp")
