"""gemma2-27b [dense] — 46L d=4608 32H (kv=16) d_ff=36864 vocab=256000,
alternating local(4096)/global attention, attn+final logit softcap, tied
embeddings.  [arXiv:2408.00118; hf]
"""
from repro_torch.models.transformer import ModelConfig
from .common import ArchSpec

NAME = "gemma2-27b"

SKIP_LONG = ("alternating local/global: the global layers are full " +
             "attention, so long_500k is skipped (local-only window would " +
             "misrepresent the arch) — DESIGN.md §Arch-applicability")


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=46, d_model=4608, num_heads=32,
        num_kv_heads=16, head_dim=128, d_ff=36864, vocab_size=256000,
        pattern=("attn", "attn"), windows=(4096, None),
        softcap=50.0, logit_softcap=30.0, tie_embeddings=True,
        act="gelu",
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        pattern=("attn", "attn"), windows=(16, None),
        softcap=50.0, logit_softcap=30.0, tie_embeddings=True, act="gelu",
        kv_repeat=2,
    )
    return ArchSpec(NAME, full, smoke, skips={"long_500k": SKIP_LONG},
                    rules="fsdp")
