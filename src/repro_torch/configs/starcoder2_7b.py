"""starcoder2-7b [dense]: 32L d4608 36H (GQA kv=4) d_ff=18432 vocab=49152,
RoPE.  [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-7b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=32, d_model=4608,
        num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
        layer_pattern=("attn+dense",), rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=72,
        num_heads=6, num_kv_heads=2, d_ff=144, vocab_size=256,
        layer_pattern=("attn+dense",), dtype="float32")
