"""Architecture registry: --arch <id> → ModelConfig (full or smoke)."""
from __future__ import annotations

from repro_torch.configs import archs
from repro_torch.configs.base import ModelConfig

FULL = archs.FULL
SMOKE = archs.SMOKE
ARCH_IDS = tuple(FULL.keys())

__all__ = ["ARCH_IDS", "FULL", "SMOKE", "ModelConfig", "get_config"]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE if smoke else FULL
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(table)}")
    return table[arch]()
