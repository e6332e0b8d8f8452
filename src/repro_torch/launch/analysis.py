"""Analytic lower bounds for the roofline's memory term (port of
`repro.launch.analysis`: the same arithmetic, so the same arguments give
the same bytes).

The dry run's counted bytes (`launch.counting`) are what the eager
program moves, every op's operands and results; this module gives the
matching floor: weights once per step at TP width, the cache read once,
activations touched twice per layer.  The defaults are one card
(chips=1, model_par=1); the reference's defaults are its 256-chip pod
with 16-way model parallelism.  The floor's time is over the card's HBM
rate (`launch.device`).
"""
from __future__ import annotations

from repro_torch.configs import archs, get_config
from repro_torch.launch.device import H100

BYTES = 2  # bf16


def kv_cache_bytes(cfg, batch: int, seq: int) -> int:
    """Global decode-state bytes for one model instance."""
    total = 0
    for spec in cfg.layer_pattern:
        mixer = spec.split("+")[0]
        n = cfg.n_periods
        if mixer in ("attn",):
            total += n * 2 * batch * seq * cfg.num_kv_heads * cfg.hd * BYTES
        elif mixer == "xattn":
            total += n * 2 * batch * cfg.vision_tokens * cfg.num_kv_heads \
                * cfg.hd * BYTES
        elif mixer == "mla":
            total += n * batch * seq * (cfg.kv_lora_rank
                                        + cfg.qk_rope_dim) * BYTES
        elif mixer == "mamba":
            d_in = cfg.mamba_expand * cfg.d_model
            total += n * batch * d_in * (cfg.mamba_d_state * 4
                                         + (cfg.mamba_d_conv - 1) * BYTES)
        elif mixer == "mlstm":
            dp = int(cfg.mlstm_proj_factor * cfg.d_model)
            dh = dp // cfg.num_heads
            total += n * batch * cfg.num_heads * (dh * dh + dh) * 4
        elif mixer == "slstm":
            total += n * batch * cfg.d_model * 4 * 4
    return total


def min_bytes_per_dev(arch: str, shape: str, chips: int = 1,
                      model_par: int = 1, weight_bytes: float = BYTES
                      ) -> float:
    """Analytic per-device HBM-bytes floor for one step."""
    cfg = get_config(arch)
    info = archs.SHAPES[shape]
    B, S, kind = info["batch"], info["seq"], info["kind"]
    w = cfg.active_param_count() * weight_bytes / model_par
    if kind == "decode":
        cache = kv_cache_bytes(cfg, B, S) / chips
        return w + cache
    acts = 2 * B * S * cfg.d_model * cfg.num_layers * BYTES / chips
    if kind == "prefill":
        cache = kv_cache_bytes(cfg, B, S) / chips   # written once
        return w + cache + acts
    # train: fwd + remat-fwd + bwd(dx) + bwd(dw) weight passes, grads +
    # optimizer state traffic (int8 m + bf16 v + bf16 params r/w)
    opt = cfg.param_count() * (2 + 2 + 1 + 1 + 2 + 2) / chips
    return 4 * w + opt + 3 * acts


def min_memory_term(arch: str, shape: str, **kw) -> float:
    """The byte floor's seconds at the card's HBM rate."""
    return min_bytes_per_dev(arch, shape, **kw) / H100.hbm_bytes_per_s
