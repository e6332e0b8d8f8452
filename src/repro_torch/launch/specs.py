"""Meta-device stand-ins for every input of a dry-run step, and their
per-rank shapes (port of `repro.launch.specs`).

Everything here allocates nothing: parameters, AdamW state and caches are
built by the port's own init functions (`models.model.init_params`,
`tree_prepare_serving` for the quantized trees, `init_cache`,
`optim.adamw.init`) on the `meta` device, so the dry run counts the
tensors the runtime holds.  The reference's NamedSharding assembly
becomes each rank's own shapes under the port's rules: the weights
sliced as the mesh Engine slices them (`sharding.shard_params`,
`sharding.serve_whole` whole), the config of one rank
(`sharding.local_config`: its query and KV heads, its d_ff and its
recurrent mixers' widths), the batch split over `data`, the AdamW moments
following their parameters; a training step's state is placed by the
Trainer's own layout (ZeRO-3 over `data`: each rank's block of every leaf
the rules cut on its `fsdp` dim).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs import archs, get_config
from repro_torch.core.bramac_linear import QuantConfig, tree_prepare_serving
from repro_torch.launch.counting import FastMeta
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.tree import tree_map

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg, shape) -> dict:
    """The batch of a step at `shape`: a SHAPES name or its
    {"batch", "seq", "kind"} dict."""
    info = archs.SHAPES[shape] if isinstance(shape, str) else shape
    B, S = info["batch"], info["seq"]
    kind = info["kind"]
    if kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    batch = {}
    if cfg.audio_frontend:
        batch["frame_embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.vision_tokens:
        batch["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                       torch.bfloat16)
    if kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def serving_quant(bits: int) -> QuantConfig:
    """The serving quantization of the dry run's q<bits> variants: bits-bit
    weights, 8-bit activations (the reference's `lower_cell`)."""
    return QuantConfig(enabled=True, bits_w=bits, bits_a=8)


@functools.lru_cache(maxsize=None)
def _float_params(cfg) -> dict:
    """`init_params` of `cfg` on meta, drawn once per config (a stand-in
    depends on nothing else; qwen3-moe-30b-a3b's expert-by-expert draw is
    ~10^5 meta ops)."""
    with FastMeta():
        return M.init_params(cfg, torch.Generator(), META)


def param_specs(cfg, quant_bits: int = 0) -> dict:
    """The parameters on meta, fresh tensors on every call: bf16
    (`cfg.dtype`) leaves, or with quant_bits the serving tree
    (`tree_prepare_serving` of them, which `init_params(serving=)` equals
    leaf for leaf)."""
    params = tree_map(torch.empty_like, _float_params(cfg))
    if quant_bits:
        with FastMeta():
            params = tree_prepare_serving(params, serving_quant(quant_bits))
    return params


def state_specs(cfg, opt_cfg: adamw.AdamWConfig, layout=None):
    """(params, opt_state) on meta: the whole tree, or one rank's under a
    training `layout` (`trainer.TrainLayout`: its blocks of the params, as
    the Trainer places them, cut over `model` and, ZeRO-3, over `data`,
    and the AdamW state of those blocks; the layout notes the splits)."""
    params = param_specs(cfg)
    with FastMeta():
        if layout is not None:
            params = layout.shard(params)
        return params, adamw.init(params, opt_cfg,
                                  layout.splits if layout else None)


def cache_specs(cfg, batch: int, max_seq: int):
    """Dense decode caches (the reference's `init_cache`) on meta."""
    with FastMeta():
        return M.init_cache(cfg, batch, max_seq, device=META)


def input_specs(arch: str, shape_name: str = "train_4k",
                opt_cfg: adamw.AdamWConfig | None = None) -> dict:
    """Meta stand-ins for every input of the step function of `arch` x
    `shape`:

    train:   {params, opt_state, batch}
    prefill: {params, batch, caches}
    decode:  {params, tokens, caches, pos}
    """
    cfg = get_config(arch)
    info = archs.SHAPES[shape_name]
    batch = batch_specs(cfg, shape_name)
    if info["kind"] == "train":
        params, opt = state_specs(cfg, opt_cfg or adamw.AdamWConfig())
        return {"params": params, "opt_state": opt, "batch": batch}
    params = param_specs(cfg)
    caches = cache_specs(cfg, info["batch"], info["seq"])
    if info["kind"] == "prefill":
        return {"params": params, "batch": batch, "caches": caches}
    return {"params": params, "tokens": batch["tokens"], "caches": caches,
            "pos": _meta((info["batch"],), torch.int32)}


# ---------------------------------------------------------------------------
# per-rank shapes
# ---------------------------------------------------------------------------

def rank_config(cfg, mesh):
    """The config one rank of `mesh` runs (its heads, d_ff and recurrent
    widths: `sharding.local_config`)."""
    if mesh is None:
        return cfg
    return sharding.local_config(cfg, mesh, "model")


def rank_params(params, ctx, cfg):
    """This rank's weights of `cfg` under a serving ctx, as the mesh
    Engine slices them (`sharding.serve_whole` whole); `params` itself
    without a ctx."""
    if ctx is None:
        return params
    with FastMeta():
        return sharding.shard_params(params, ctx,
                                     whole=sharding.serve_whole(cfg))


def rank_batch(batch, mesh):
    """Each leaf's rows that a data rank of `mesh` takes
    (`sharding.data_rows`, the mesh Engine's rule: a block of rows/n, or
    all of them when n does not divide, as the reference's
    `batch_shardings` leave them)."""
    def take(t):
        lo, hi = sharding.data_rows(t.shape[0], mesh)
        if hi - lo == t.shape[0]:
            return t
        return _meta((hi - lo,) + tuple(t.shape[1:]), t.dtype)
    return tree_map(take, batch)
