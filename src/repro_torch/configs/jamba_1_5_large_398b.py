"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 1:7 interleave with MoE every
other layer.  [arXiv:2403.19887]

Period of 8 layers: attention at position 4, Mamba elsewhere; MoE FFN on
odd positions, dense FFN on even — 1 attn : 7 mamba and MoE every 2 ✓.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "jamba-1.5-large-398b"

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba") + "+" + ("moe" if i % 2 else "dense")
    for i in range(8))


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", num_layers=72, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=24576, vocab_size=65536,
        layer_pattern=_PATTERN, num_experts=16, experts_per_token=2,
        moe_d_ff=24576, mamba_d_state=16, mamba_expand=2, mamba_d_conv=4)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256,
        layer_pattern=_PATTERN, num_experts=4, experts_per_token=2,
        moe_d_ff=96, mamba_d_state=4, mamba_expand=2, mamba_d_conv=4,
        dtype="float32", chunk_size=8)
