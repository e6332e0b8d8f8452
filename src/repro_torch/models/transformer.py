"""Layer stack: pattern-driven blocks over stacked per-period parameters.

Port of `repro.models.transformer` for blocks of the `attn` (GQA) and `mla`
(multi-head latent attention) mixers with the `dense` (SwiGLU) or `moe`
(`models.moe`) feed-forward.  Parameters of pattern position i are stacked
over `n_periods` as in the reference (`params["pos{i}"][leaf]` with a
leading period axis); `stack_apply` walks the periods in a Python loop over
period slices (views, no copies) and sums the MoE aux losses.  The other
mixers (xattn, mamba, mlstm, slstm) and the `none` FF raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

MIXERS = ("attn", "mla", "xattn", "mamba", "mlstm", "slstm")
FFS = ("dense", "moe", "none")
SERVED_MIXERS = ("attn", "mla")
SERVED_FFS = ("dense", "moe")


def parse_spec(spec: str) -> tuple[str, str]:
    mixer, ff = spec.split("+")
    if mixer not in MIXERS or ff not in FFS:
        raise ValueError(f"bad layer spec {spec!r}")
    if mixer not in SERVED_MIXERS:
        raise NotImplementedError(
            f"layer {spec!r}: the {mixer} mixer is not ported yet (the "
            f"port serves {', '.join(SERVED_MIXERS)})")
    if ff not in SERVED_FFS:
        raise NotImplementedError(
            f"layer {spec!r}: the {ff!r} feed-forward is not ported yet "
            f"(the port serves {', '.join(SERVED_FFS)})")
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
    mixer, ff = parse_spec(spec)
    dt = cfg.compute_dtype
    init = attn.init_gqa if mixer == "attn" else attn.init_mla
    p = {"norm1": init_rmsnorm(cfg.d_model, dt, device),
         "mixer": init(gen, cfg, device),
         "norm2": init_rmsnorm(cfg.d_model, dt, device)}
    if ff == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def init_block_cache(cfg, spec: str, batch: int, max_seq: int, dtype,
                     num_pages=None, device=None):
    """Decode-time KV state for one block (paged pool when num_pages)."""
    mixer, _ = parse_spec(spec)
    init = attn.init_gqa_cache if mixer == "attn" else attn.init_mla_cache
    return init(cfg, batch, max_seq, dtype, num_pages, device)


# ---------------------------------------------------------------------------
# per-block apply
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg, spec, *, positions, cache=None, cache_pos=None,
                paged=None):
    """Returns (x, aux_loss, cache).  `paged` (a PagedKV or DenseKV
    bundle) selects the cache discipline inside gqa/mla; its decode_kernel
    flag routes Sq=1 gqa reads through the paged-decode kernels, and mla
    ignores it (it always reads through the gather)."""
    mixer, ff = parse_spec(spec)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix = attn.gqa if mixer == "attn" else attn.mla
    y, new_cache = mix(p["mixer"], h, cfg, positions, cache, cache_pos,
                       paged)
    x = x + y
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ff == "moe":
        y, aux = moe_mod.moe(p["moe"], h, cfg)
        return x + y, aux, new_cache
    x = x + mlp(p["mlp"], h, cfg.quant)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def init_stack(gen, cfg, device, prepare=None):
    """{"pos{i}": stacked-over-periods block params}.  Each stacked leaf is
    allocated once and filled period by period, so a full-size model never
    holds more than one period of f32 draws at a time.  `prepare` (the
    serving quantizer) maps each period's block before it is stored, so a
    quantized model never holds its float weights either."""
    params = {}
    for i, spec in enumerate(cfg.layer_pattern):
        stacked = None
        for period in range(cfg.n_periods):
            one = init_block(gen, cfg, spec, device)
            if prepare is not None:
                one = prepare(one)
            if stacked is None:
                stacked = _alloc_stacked(one, cfg.n_periods)
            _copy_into(stacked, one, period)
            del one
        params[f"pos{i}"] = stacked
    return params


def _alloc_stacked(one, n):
    """Empty leaves of `one`'s tree with a leading axis of n periods."""
    if isinstance(one, dict):
        return {k: _alloc_stacked(v, n) for k, v in one.items()}

    def empty(a):
        return torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                           device=a.device)
    if isinstance(one, QuantizedTensor):
        return dataclasses.replace(one.map(empty),
                                   shape=(n,) + tuple(one.shape))
    return empty(one)


def _copy_into(dst, src, i):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v, i)
        elif isinstance(v, QuantizedTensor):
            dst[k].values[i].copy_(v.values)
            dst[k].scale[i].copy_(v.scale)
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
    shared page-pool leaves: every leaf of an attn block (k, v and the int8
    scales) and of an mla block (c_kv, k_rope)."""
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
