"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (kv=8) d_ff=24576
vocab=65536, Mamba:attn 7:1 interleave, MoE 16e top-2 every other layer,
no positional embedding on attention.  [arXiv:2403.19887; hf]

Runs long_500k: 63/72 layers carry O(1) SSM state; the 9 attention layers'
500k KV caches are sequence-sharded over the model axis.
Optimizer state is int8 (state_bits=8) so master+m+v fit 16GB/chip — see
EXPERIMENTS.md §Dry-run.
"""
from repro_torch.models.mamba import MambaConfig
from repro_torch.models.transformer import ModelConfig, MoEConfig
from .common import ArchSpec

NAME = "jamba-1.5-large-398b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=72, d_model=8192, num_heads=64,
        num_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
        pattern=("mamba", "mamba", "mamba", "attn",
                 "mamba", "mamba", "mamba", "mamba"),
        use_rope=False, kv_repeat=2,
        mamba=MambaConfig(d_model=8192, d_inner=16384, d_state=16, chunk=128),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, dispatch="sort"),
        moe_period=2,
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        pattern=("mamba", "mamba", "mamba", "attn",
                 "mamba", "mamba", "mamba", "mamba"),
        use_rope=False, kv_repeat=2,
        mamba=MambaConfig(d_model=64, d_inner=128, d_state=8, chunk=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=128, dispatch="sort"),
        moe_period=2,
    )
    return ArchSpec(NAME, full, smoke, skips={}, rules="fsdp", opt_bits=8)
