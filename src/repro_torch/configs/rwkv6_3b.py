"""rwkv6-3b "Finch" [ssm] — 32L d=2560, attn-free, d_ff=8960 vocab=65536,
data-dependent decay.  [arXiv:2404.05892; hf]

Runs long_500k: the recurrent state is O(1) in sequence length.
"""
from repro_torch.models.rwkv import RWKVConfig
from repro_torch.models.transformer import ModelConfig
from .common import ArchSpec

NAME = "rwkv6-3b"


def spec() -> ArchSpec:
    full = ModelConfig(
        name=NAME, num_layers=32, d_model=2560, num_heads=40,
        num_kv_heads=40, d_ff=8960, vocab_size=65536,
        pattern=("rwkv",),
        rwkv=RWKVConfig(d_model=2560, d_ff=8960, head_size=64, chunk=32),
    )
    smoke = ModelConfig(
        name=NAME + "-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=512,
        pattern=("rwkv",),
        rwkv=RWKVConfig(d_model=64, d_ff=128, head_size=16, chunk=8),
    )
    return ArchSpec(NAME, full, smoke, skips={})
