"""granite-8b [dense]: 36L d4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch, code.  [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-8b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=36, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=49152,
        layer_pattern=("attn+dense",), rope_theta=10_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=112, vocab_size=256,
        layer_pattern=("attn+dense",), dtype="float32")
