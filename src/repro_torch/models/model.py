"""Top-level model API: init / train forward / loss / prefill / decode
(port of `repro.models.model`).

Batch dict conventions, as the reference's:
  LM / code / dense / moe : {"tokens": (B,S) i32, "labels": (B,S) i32}
  vlm   : + {"vision_embeds": (B, T_v, D)}   (stub frontend)
  audio : {"frame_embeds": (B,S,D), "labels": (B,S)}  (stub EnCodec)

Serving:
  prefill(params, batch, cfg, caches)          — writes the cache, returns
                                                 last logits
  decode_step(params, tokens, cfg, caches, pos) — one token per sequence
Caches are written in place and returned.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bramac_linear import QuantConfig, tree_prepare_serving
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cross_entropy, embed, init_embed, \
    init_rmsnorm, rmsnorm, unembed
from repro_torch.parallel import sharding


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, serving: QuantConfig | None = None) -> dict:
    """Random weights in the reference's tree structure and he_init
    scaling, drawn from `generator` (which must live on `device`).

    With `serving` (an enabled QuantConfig) each period's block is
    quantized as soon as it is drawn: the result equals
    `tree_prepare_serving(init_params(cfg, generator, device), serving)`
    leaf for leaf, without ever holding the float stack (qwen3-moe-30b-a3b's
    bf16 experts alone are ~58 GB; one period of jamba-1.5-large-398b holds
    four MoE blocks of 19.3 GB at bf16 each).  At most one block is float
    at a time, and its expert stacks are drawn one expert at a time."""
    dt = cfg.compute_dtype
    prepare = None
    if serving is not None and serving.enabled:
        prepare = functools.partial(tree_prepare_serving, cfg=serving)
    emb = init_embed(generator, cfg.vocab_size, cfg.d_model, dt, device)
    if prepare is not None:
        emb = prepare(emb)
    return {"embed": emb,
            "final_norm": init_rmsnorm(cfg.d_model, dt, device),
            "layers": tf.init_stack(generator, cfg, device, prepare)}


def _inputs_to_hidden(params, batch, cfg):
    if "frame_embeds" in batch:                      # audio stub frontend
        return batch["frame_embeds"].to(cfg.compute_dtype)
    emb = params["embed"]
    return embed({"embedding": sharding.gather_leaf(
        emb["embedding"], "embed/embedding")}, batch["tokens"])


def forward(params, batch, cfg: ModelConfig, caches=None, cache_pos=None,
            last_only: bool = False, gather_pos=None, paged=None):
    """Returns (logits, aux_loss, caches).

    last_only: unembed only the final position.
    gather_pos: (B,) per-sequence row to unembed instead (chunked prefill);
    returns (B, 1, vocab) logits like last_only.
    paged: an attention.PagedKV bundle — caches hold shared page pools and
    attention reads/writes KV rows through its block tables; with
    decode_kernel set, S=1 reads go through the paged-decode kernels.
    Under a ZeRO-3 training ctx the embedding, each block's weights and
    the unembed are gathered whole right before their use
    (`sharding.gather_leaf`)."""
    x = _inputs_to_hidden(params, batch, cfg)
    B, S = x.shape[:2]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    if cache_pos is not None:
        positions = cache_pos.to(torch.int32)[:, None] + ar
    else:
        positions = ar.expand(B, S)
    ve = batch.get("vision_embeds")
    if ve is not None:
        ve = ve.to(cfg.compute_dtype)
    x, aux, caches = tf.stack_apply(params["layers"], x, cfg,
                                    positions=positions, vision_embeds=ve,
                                    caches=caches, cache_pos=cache_pos,
                                    paged=paged)
    if last_only:
        x = x[:, -1:]
    elif gather_pos is not None:
        idx = gather_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    emb = params["embed"]
    emb = {**emb, "unembed": sharding.gather_leaf(emb["unembed"],
                                                   "embed/unembed")}
    return unembed(emb, x, cfg.quant), aux, caches


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01):
    """Mean token cross-entropy plus `aux_weight` x the MoE aux loss.
    Returns (loss, {"ce", "aux"})."""
    logits, aux, _ = forward(params, batch, cfg)
    loss = cross_entropy(logits, batch["labels"])
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, num_pages=None,
               device=None):
    """num_pages=None: dense [batch, max_seq] KV reservations; otherwise a
    shared pool of `num_pages` pages of `cfg.page_size` rows per layer."""
    return tf.init_stack_cache(cfg, batch, max_seq, cfg.compute_dtype,
                               num_pages, device)


def cache_pool_flags(cfg: ModelConfig):
    """Tree matching init_cache(num_pages=...) with True at shared-pool
    leaves, False at per-slot leaves (recurrent state, xattn KV)."""
    return tf.stack_cache_pool_flags(cfg)


def prefill(params, batch, cfg: ModelConfig, caches):
    """Run the prompt through the model, filling the cache from row 0.
    Returns (last_token_logits (B,V), caches)."""
    x = batch["frame_embeds"] if "frame_embeds" in batch else batch["tokens"]
    cache_pos = torch.zeros((x.shape[0],), dtype=torch.int32,
                            device=x.device)
    logits, _, caches = forward(params, batch, cfg, caches, cache_pos,
                                last_only=True)
    return logits[:, -1], caches


def decode_step(params, tokens, cfg: ModelConfig, caches, pos, paged=None):
    """tokens: (B,1) i32; pos: (B,) position being written.
    Returns (logits (B,V), caches)."""
    logits, _, caches = forward(params, {"tokens": tokens}, cfg, caches,
                                cache_pos=pos, paged=paged)
    return logits[:, 0], caches
