"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer; the vision
frontend is a STUB — input_specs() provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"

_PATTERN = ("xattn+dense",) + ("attn+dense",) * 4   # cross-attn every 5


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
        layer_pattern=_PATTERN, vision_tokens=1600, rope_theta=500_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=112, vocab_size=256,
        layer_pattern=_PATTERN, vision_tokens=16, dtype="float32")
