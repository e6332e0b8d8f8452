"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
input_specs() provides precomputed frame embeddings.  [arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "musicgen-large"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=2048,
        layer_pattern=("attn+dense",), audio_frontend=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
        layer_pattern=("attn+dense",), audio_frontend=True, dtype="float32")
