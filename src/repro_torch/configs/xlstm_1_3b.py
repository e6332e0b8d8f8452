"""xlstm-1.3b [ssm]: 48L d2048 4H d_ff=0 (projections live inside the
sLSTM/mLSTM blocks) vocab=50304, xLSTM[7:1] — 7 mLSTM : 1 sLSTM.
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "xlstm-1.3b"

_PATTERN = ("mlstm+none",) * 7 + ("slstm+none",)    # xLSTM[7:1]


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm", num_layers=48, d_model=2048,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        layer_pattern=_PATTERN, mlstm_proj_factor=2.0,
        slstm_proj_factor=4.0 / 3.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=256,
        layer_pattern=_PATTERN, dtype="float32", chunk_size=8)
