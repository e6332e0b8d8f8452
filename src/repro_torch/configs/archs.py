"""Aggregated registry of the 10 assigned architectures."""
from __future__ import annotations

from repro_torch.configs import (dbrx_132b, granite_8b, internlm2_20b,
                           jamba_1_5_large_398b, llama_3_2_vision_11b,
                           minicpm3_4b, musicgen_large, qwen3_moe_30b_a3b,
                           starcoder2_7b, xlstm_1_3b)

_MODULES = (dbrx_132b, qwen3_moe_30b_a3b, jamba_1_5_large_398b, minicpm3_4b,
            internlm2_20b, starcoder2_7b, granite_8b, llama_3_2_vision_11b,
            musicgen_large, xlstm_1_3b)

FULL = {m.ARCH_ID: m.full_config for m in _MODULES}
SMOKE = {m.ARCH_ID: m.smoke_config for m in _MODULES}

# Shape applicability (DESIGN.md §5): long_500k needs sub-quadratic mixers.
SUBQUADRATIC = ("jamba-1.5-large-398b", "xlstm-1.3b")

SHAPES = {
    "train_4k":    {"seq": 4096,    "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768,   "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32768,   "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524288,  "batch": 1,   "kind": "decode"},
}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch × shape) cells; inapplicable ones are reported
    as skipped-by-design (8 long_500k cells for full-attention archs)."""
    return [(a, s) for a in FULL for s in SHAPES]
