"""Layer stack: pattern-driven blocks over stacked per-period parameters.

Port of `repro.models.transformer`: blocks of the `attn` (GQA), `mla`
(multi-head latent attention), `xattn` (cross-attention over vision
embeddings), `mamba`, `mlstm` and `slstm` mixers with the `dense`
(SwiGLU), `moe` (`models.moe`) or `none` feed-forward.  Parameters of
pattern position i are stacked over `n_periods` as in the reference
(`params["pos{i}"][leaf]` with a leading period axis); `stack_apply` walks
the periods in a Python loop over period views, each stacked leaf unbound
once (so autograd gathers one stacked gradient per leaf, not one
full-size gradient per period), and sums the MoE aux losses.  Under a
ZeRO-3 training ctx each period's view of a leaf cut over `data` is
gathered whole right before its block runs (`sharding.gather_uses`), so
no more than one period's whole weights are gathered at a time.
Attention caches are written in place; a recurrent mixer's state (a
tuple, as in the reference) is copied into its cache slice after each
call.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm
from repro_torch.parallel import sharding
from repro_torch.tree import tree_map

MIXERS = ("attn", "mla", "xattn", "mamba", "mlstm", "slstm")
FFS = ("dense", "moe", "none")
RECURRENT = ("mamba", "mlstm", "slstm")


def parse_spec(spec: str) -> tuple[str, str]:
    mixer, ff = spec.split("+")
    if mixer not in MIXERS or ff not in FFS:
        raise ValueError(f"bad layer spec {spec!r}")
    return mixer, ff


def is_recurrent(cfg) -> bool:
    """Whether any layer keeps a recurrent state (mamba/mlstm/slstm)."""
    return any(m in spec for spec in cfg.layer_pattern for m in RECURRENT)


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------

def init_block(gen, cfg, spec: str, device):
    mixer, ff = parse_spec(spec)
    dt = cfg.compute_dtype
    init = {"attn": attn.init_gqa, "mla": attn.init_mla,
            "xattn": attn.init_xattn, "mamba": mb.init_mamba,
            "mlstm": xl.init_mlstm, "slstm": xl.init_slstm}[mixer]
    p: dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dt, device),
                         "mixer": init(gen, cfg, device)}
    if ff != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dt, device)
        if ff == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg, device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def init_block_cache(cfg, spec: str, batch: int, max_seq: int, dtype,
                     num_pages=None, device=None):
    """Decode-time state for one block: attention KV (a paged pool when
    num_pages), or a recurrent mixer's per-slot state tuple or the
    cross-attention's projected vision K/V, which are the same in both
    layouts (the "registers" of a slot, not token storage)."""
    mixer, _ = parse_spec(spec)
    if mixer == "attn":
        return attn.init_gqa_cache(cfg, batch, max_seq, dtype, num_pages,
                                   device)
    if mixer == "mla":
        return attn.init_mla_cache(cfg, batch, max_seq, dtype, num_pages,
                                   device)
    if mixer == "xattn":
        return attn.init_xattn_cache(cfg, batch, dtype, device)
    if mixer == "mamba":
        return mb.init_mamba_state(cfg, batch, dtype, device)
    if mixer == "mlstm":
        return xl.init_mlstm_state(cfg, batch, device)
    return xl.init_slstm_state(cfg, batch, device)


# ---------------------------------------------------------------------------
# per-block apply
# ---------------------------------------------------------------------------

_STEP = {"mamba": mb.mamba_step, "mlstm": xl.mlstm_step,
         "slstm": xl.slstm_step}
_SEQUENCE = {"mamba": mb.mamba_sequence, "mlstm": xl.mlstm_sequence,
             "slstm": xl.slstm_sequence}


def block_apply(p, x, cfg, spec, *, positions, vision_embeds=None,
                cache=None, cache_pos=None, paged=None):
    """Returns (x, aux_loss, cache).  `paged` (a PagedKV or DenseKV
    bundle) selects the cache discipline inside gqa/mla; its decode_kernel
    flag routes Sq=1 gqa reads through the paged-decode kernels, and mla
    ignores it (it always reads through the gather).  A recurrent mixer
    takes its step with the cached state when S == 1 and a cache is given,
    else runs the sequence from the init state (as the reference does);
    the new state is written into `cache` in place, for the sequences the
    bundle's write_mask allows (every sequence without a bundle)."""
    mixer, ff = parse_spec(spec)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer in _STEP:
        if cache is not None and x.shape[1] == 1:
            y, state = _STEP[mixer](p["mixer"], h, cfg, cache)
        else:
            y, state = _SEQUENCE[mixer](p["mixer"], h, cfg)
        if cache is not None:
            for dst, src in zip(cache, state):
                if paged is not None:
                    keep = paged.write_mask.reshape((-1,) + (1,) * (
                        dst.ndim - 1))
                    src = torch.where(keep, src, dst)
                dst.copy_(src)
    elif mixer == "xattn":
        y, _ = attn.xattn(p["mixer"], h, cfg, vision_embeds, cache,
                          cache_pos)
    else:
        mix = attn.gqa if mixer == "attn" else attn.mla
        y, _ = mix(p["mixer"], h, cfg, positions, cache, cache_pos, paged)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ff == "none":
        return x, aux, cache
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ff == "moe":
        y, aux = moe_mod.moe(p["moe"], h, cfg)
        return x + y, aux, cache
    return x + mlp(p["mlp"], h, cfg.quant), aux, cache


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
    shared page-pool leaves — every leaf of an attn block (k, v and the
    int8 scales) and of an mla block (c_kv, k_rope) — and False at per-slot
    leaves (recurrent state, xattn KV), which engines reset by slot.  The
    dense layout has the same structure, True at its KV leaves."""
    flags = {}
    for i, spec in enumerate(cfg.layer_pattern):
        is_pool = parse_spec(spec)[0] in ("attn", "mla")
        shapes = init_block_cache(cfg, spec, 1, cfg.page_size, torch.float32,
                                  num_pages=1, device="meta")
        flags[f"pos{i}"] = tree_map(lambda _: is_pool, shapes)
    return flags


def unstack(tree, n: int) -> list:
    """The n period views of a stacked tree.  Each tensor leaf is unbound
    once: autograd then stacks the periods' gradients into one tensor,
    where indexing per period would give each period's gradient the full
    stacked size.  QuantizedTensor leaves (never differentiated) are
    sliced."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [unstack(v, n) for v in tree]
        return [tuple(v[i] for v in parts) for i in range(n)]
    if isinstance(tree, QuantizedTensor):
        return [tree.map(lambda a, i=i: a[i]) for i in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    return [tree] * n


def stack_apply(params, x, cfg, *, positions, vision_embeds=None,
                caches=None, cache_pos=None, paged=None):
    """Walk the periods in order.  Returns (x, aux_total, caches); caches
    are updated in place through per-period views.  Each block's weights
    are gathered for its use under a ZeRO-3 ctx (`sharding.gather_uses`;
    nothing without one)."""
    n = cfg.n_periods
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    p_views = [unstack(params[f"pos{i}"], n)
               for i in range(len(cfg.layer_pattern))]
    for period in range(n):
        for i, spec in enumerate(cfg.layer_pattern):
            cache_i = None if caches is None else \
                tree_map(lambda a: a[period], caches[f"pos{i}"])
            p = sharding.gather_uses(p_views[i][period], f"layers/pos{i}",
                                     drop=1)
            x, aux, _ = block_apply(p, x, cfg, spec,
                                    positions=positions,
                                    vision_embeds=vision_embeds,
                                    cache=cache_i, cache_pos=cache_pos,
                                    paged=paged)
            aux_total = aux_total + aux
    return x, aux_total, caches
