"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
[arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internlm2-20b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=48, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
        layer_pattern=("attn+dense",), rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        layer_pattern=("attn+dense",), dtype="float32")
