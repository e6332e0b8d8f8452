"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=4, d_ff=768, vocab_size=151936,
        layer_pattern=("attn+moe",), num_experts=128, experts_per_token=8,
        moe_d_ff=768, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=256,
        layer_pattern=("attn+moe",), num_experts=8, experts_per_token=2,
        moe_d_ff=48, dtype="float32")
