"""Layer stack: pattern-driven blocks over stacked per-period parameters.

Port of `repro.models.transformer` for `attn+dense` blocks.  Parameters of
pattern position i are stacked over `n_periods` as in the reference
(`params["pos{i}"][leaf]` with a leading period axis); `stack_apply` walks
the periods in a Python loop over period slices (views, no copies).  The
other mixers and FFs raise NotImplementedError until their slice lands.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

MIXERS = ("attn", "mla", "xattn", "mamba", "mlstm", "slstm")
FFS = ("dense", "moe", "none")


def parse_spec(spec: str) -> tuple[str, str]:
    mixer, ff = spec.split("+")
    if mixer not in MIXERS or ff not in FFS:
        raise ValueError(f"bad layer spec {spec!r}")
    if (mixer, ff) != ("attn", "dense"):
        raise NotImplementedError(
            f"layer {spec!r}: only attn+dense blocks are ported so far; "
            "the mla, xattn, MoE, Mamba and xLSTM layers are not ported yet")
    return mixer, ff


def tree_map(fn, tree):
    """Map `fn` over the tensors of a nested-dict tree (QuantizedTensor
    leaves map their values and scale)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.map(fn)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------

def init_block(gen, cfg, spec: str, device):
    parse_spec(spec)
    dt = cfg.compute_dtype
    return {"norm1": init_rmsnorm(cfg.d_model, dt, device),
            "mixer": attn.init_gqa(gen, cfg, device),
            "norm2": init_rmsnorm(cfg.d_model, dt, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)}


def init_block_cache(cfg, spec: str, batch: int, max_seq: int, dtype,
                     num_pages=None, device=None):
    """Decode-time KV state for one block (paged pool when num_pages)."""
    parse_spec(spec)
    return attn.init_gqa_cache(cfg, batch, max_seq, dtype, num_pages, device)


# ---------------------------------------------------------------------------
# per-block apply
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg, spec, *, positions, cache=None, cache_pos=None,
                paged=None):
    """Returns (x, aux_loss, cache)."""
    parse_spec(spec)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, new_cache = attn.gqa(p["mixer"], h, cfg, positions, cache, cache_pos,
                            paged)
    x = x + y
    x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.quant)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_stack(gen, cfg, device):
    """{"pos{i}": stacked-over-periods block params}.  Each stacked leaf is
    allocated once and filled period by period, so a full-size model never
    holds more than one period of f32 draws at a time."""
    params = {}
    for i, spec in enumerate(cfg.layer_pattern):
        stacked = None
        for period in range(cfg.n_periods):
            one = init_block(gen, cfg, spec, device)
            if stacked is None:
                stacked = tree_map(lambda a: torch.empty(
                    (cfg.n_periods,) + tuple(a.shape), dtype=a.dtype,
                    device=a.device), one)
            _copy_into(stacked, one, period)
        params[f"pos{i}"] = stacked
    return params


def _copy_into(dst, src, i):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def init_stack_cache(cfg, batch, max_seq, dtype, num_pages=None, device=None):
    caches = {}
    for i, spec in enumerate(cfg.layer_pattern):
        one = init_block_cache(cfg, spec, batch, max_seq, dtype, num_pages,
                               device)
        caches[f"pos{i}"] = tree_map(
            lambda a: a[None].repeat((cfg.n_periods,) + (1,) * a.ndim), one)
    return caches


def stack_cache_pool_flags(cfg):
    """A tree matching init_stack_cache's paged structure with True at
    shared page-pool leaves (every leaf of an attn block)."""
    flags = {}
    for i, spec in enumerate(cfg.layer_pattern):
        shapes = init_block_cache(cfg, spec, 1, cfg.page_size, torch.float32,
                                  num_pages=1, device="meta")
        flags[f"pos{i}"] = tree_map(lambda _: True, shapes)
    return flags


def stack_apply(params, x, cfg, *, positions, caches=None, cache_pos=None,
                paged=None):
    """Walk the periods in order.  Returns (x, aux_total, caches); caches
    are updated in place through per-period views."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for period in range(cfg.n_periods):
        for i, spec in enumerate(cfg.layer_pattern):
            p_i = tree_map(lambda a: a[period], params[f"pos{i}"])
            cache_i = None if caches is None else \
                tree_map(lambda a: a[period], caches[f"pos{i}"])
            x, aux, _ = block_apply(p_i, x, cfg, spec, positions=positions,
                                    cache=cache_i, cache_pos=cache_pos,
                                    paged=paged)
            aux_total = aux_total + aux
    return x, aux_total, caches
