"""minicpm3-4b [dense]: 62L d2560 40H d_ff=6400 vocab=73448, MLA
(multi-head latent attention: q_lora 768, kv_lora 256).
[hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minicpm3-4b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", num_layers=62, d_model=2560,
        num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73448,
        layer_pattern=("mla+dense",), q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        layer_pattern=("mla+dense",), q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, dtype="float32")
