"""Top-level model API: init / forward / prefill / decode (port of
`repro.models.model` for token LMs).

Serving:
  prefill(params, batch, cfg, caches)          — writes the cache, returns
                                                 last logits
  decode_step(params, tokens, cfg, caches, pos) — one token per sequence
Caches are written in place and returned.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed, init_embed, init_rmsnorm, \
    rmsnorm, unembed


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random weights in the reference's tree structure and he_init
    scaling, drawn from `generator` (which must live on `device`)."""
    dt = cfg.compute_dtype
    return {"embed": init_embed(generator, cfg.vocab_size, cfg.d_model, dt,
                                device),
            "final_norm": init_rmsnorm(cfg.d_model, dt, device),
            "layers": tf.init_stack(generator, cfg, device)}


def forward(params, batch, cfg: ModelConfig, caches=None, cache_pos=None,
            last_only: bool = False, gather_pos=None, paged=None):
    """Returns (logits, aux_loss, caches).

    last_only: unembed only the final position.
    gather_pos: (B,) per-sequence row to unembed instead (chunked prefill);
    returns (B, 1, vocab) logits like last_only.
    paged: an attention.PagedKV bundle — caches hold shared page pools and
    attention reads/writes KV rows through its block tables; with
    decode_kernel set, S=1 reads go through the paged-decode kernels."""
    if "tokens" not in batch:
        raise NotImplementedError("only token inputs are ported so far "
                                  "(not the vision and audio frontend stubs)")
    x = embed(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    ar = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    if cache_pos is not None:
        positions = cache_pos.to(torch.int32)[:, None] + ar
    else:
        positions = ar.expand(B, S)
    x, aux, caches = tf.stack_apply(params["layers"], x, cfg,
                                    positions=positions, caches=caches,
                                    cache_pos=cache_pos, paged=paged)
    if last_only:
        x = x[:, -1:]
    elif gather_pos is not None:
        idx = gather_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg.quant), aux, caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, num_pages=None,
               device=None):
    """num_pages=None: dense [batch, max_seq] KV reservations; otherwise a
    shared pool of `num_pages` pages of `cfg.page_size` rows per layer."""
    return tf.init_stack_cache(cfg, batch, max_seq, cfg.compute_dtype,
                               num_pages, device)


def cache_pool_flags(cfg: ModelConfig):
    """Tree matching init_cache(num_pages=...) with True at shared-pool
    leaves."""
    return tf.stack_cache_pool_flags(cfg)


def prefill(params, batch, cfg: ModelConfig, caches):
    """Run the prompt through the model, filling the cache from row 0.
    Returns (last_token_logits (B,V), caches)."""
    B = batch["tokens"].shape[0]
    cache_pos = torch.zeros((B,), dtype=torch.int32,
                            device=batch["tokens"].device)
    logits, _, caches = forward(params, batch, cfg, caches, cache_pos,
                                last_only=True)
    return logits[:, -1], caches


def decode_step(params, tokens, cfg: ModelConfig, caches, pos, paged=None):
    """tokens: (B,1) i32; pos: (B,) position being written.
    Returns (logits (B,V), caches)."""
    logits, _, caches = forward(params, {"tokens": tokens}, cfg, caches,
                                cache_pos=pos, paged=paged)
    return logits[:, 0], caches
