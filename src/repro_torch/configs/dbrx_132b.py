"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "dbrx-132b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=8, d_ff=10752, vocab_size=100352,
        layer_pattern=("attn+moe",), num_experts=16, experts_per_token=4,
        moe_d_ff=10752, rope_theta=500_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=112, vocab_size=256,
        layer_pattern=("attn+moe",), num_experts=4, experts_per_token=2,
        moe_d_ff=112, dtype="float32")
