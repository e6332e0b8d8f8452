"""GQA and MLA attention (+RoPE) with dense or paged KV caches.

Port of the GQA and MLA parts of `repro.models.attention`.  Modes, as the
reference's:
  * train/prefill without a cache: causal attention, query-chunked;
  * serving: a decode step or prefill chunk against a KV cache written in
    place — a dense (B, max_seq, …) reservation, or a shared pool of
    (page_size,)-row pages addressed through per-sequence block tables
    (`PagedKV`).

The port writes caches in place (PyTorch tensors are mutable; the
reference returns updated copies) and returns the same dict.  Paged reads
for Sq=1 decode go through the hand-written CUDA kernels
(`kernels/paged_attention.py`) when the bundle's `decode_kernel` is set;
the gather (`paged_view` + `chunk_attention`) stays the oracle and the
Sq>1 path.  Dense prefill chunks, the speculative verify window and the
draft model's cache write through a `DenseKV` bundle, whose write mask
keeps the rows of slots that are not writing and whose bound drops rows a
non-speculative run could not reach.  MLA (multi-head latent attention,
MiniCPM3/DeepSeek style) caches only the normed latent `c_kv` and the
roped `k_rope`, in the compute dtype (`quant_kv` does not apply), and
always reads through the gather: its up-projections run over the whole
gathered view, and the decode kernels, which read GQA pools, are never
its path.  Cross-attention (xattn: text queries over precomputed image
patch embeddings) projects its position-free K/V once, at prefill, into a
per-slot cache that decode steps read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels import paged_attention as pk
from repro_torch.models.layers import (apply_rope, column_input,
                                       column_inputs, dense, dense_row,
                                       init_dense, init_rmsnorm, rmsnorm)

Q_CHUNK = 1024


# ---------------------------------------------------------------------------
# paged KV layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKV:
    """Block-table view of a shared page pool for one call.

    tables     (B, max_pages) i32 — page id of each sequence's page j;
               unallocated entries may hold any in-range id (their rows are
               only ever read masked).
    n_pages    (B,) i32 — pages allocated per sequence; writes at or past
               `n_pages * page_size` are dropped.
    write_mask (B,) bool — sequences allowed to write this call.
    owned      (B, max_pages) bool or None — per-entry write permission
               (None: every allocated entry is writable).
    bound      (B,) i32 or None — writes at positions >= bound drop.
    decode_kernel — route Sq=1 reads through the paged-decode kernels.
    sync       callable or None — called with a layer's cache dict after
               the layer wrote its rows and before it reads: the mesh
               Engine's data ranks land each other's rows there when a
               row's result reaches other rows (MoE routing).
    """
    tables: torch.Tensor
    n_pages: torch.Tensor
    write_mask: torch.Tensor
    max_seq: int
    page_size: int
    owned: torch.Tensor | None = None
    bound: torch.Tensor | None = None
    decode_kernel: bool = False
    sync: Any = None


@dataclasses.dataclass
class DenseKV:
    """Write discipline for the dense layout when rows are scattered at
    per-row positions (prefill chunks, the speculative verify window, the
    draft model's cache): write_mask gates whole sequences, rows at or past
    max_seq drop instead of sliding back over earlier rows, and `bound` is
    the same per-sequence accepted-length bound PagedKV carries."""
    write_mask: torch.Tensor                    # (B,) bool
    max_seq: int
    bound: torch.Tensor | None = None           # (B,) i32


def _scatter_drop(buf, index, vals, ok):
    """buf[index] = vals for rows where `ok`, in place; the other rows drop.
    Each dropped row is given the target and value of the first kept row,
    so the scatter writes the same value twice there; when no row is kept,
    the first row's target gets its own current contents back.  No host
    sync and no data-dependent shape."""
    # first kept row, or 0; a 1-element index (a 0-d one would sync)
    donor = torch.argmax(ok.to(torch.int32)).reshape(1)
    d_index = tuple(i[donor] for i in index)
    donor_val = torch.where(ok.any(), vals[donor], buf[d_index])
    keep = ok.reshape((-1,) + (1,) * (vals.ndim - 1))
    buf.index_put_(tuple(torch.where(ok, i, d) for i, d in zip(index,
                                                                 d_index)),
                   torch.where(keep, vals, donor_val))
    return buf


def dense_update(cache, new, positions, dv: DenseKV):
    """Write `new` (B, S, …) rows into the dense cache (B, max_seq, …) at
    absolute `positions` (B, S), in place; masked and out-of-range rows
    drop (both bounds: a negative position would wrap onto the tail), and
    so do rows at or past `dv.bound`."""
    ok = dv.write_mask[:, None] & (positions < dv.max_seq) & (positions >= 0)
    if dv.bound is not None:
        ok = ok & (positions < dv.bound[:, None])
    B, S = positions.shape
    batch = torch.arange(B, device=positions.device)[:, None].expand(B, S)
    vals = new.reshape((B * S,) + tuple(cache.shape[2:])).to(cache.dtype)
    return _scatter_drop(cache, (batch.reshape(-1),
                                 positions.clamp(0, cache.shape[1] - 1)
                                 .reshape(-1).long()),
                         vals, ok.reshape(-1))


def paged_update(pool, new, positions, pv: PagedKV):
    """Write `new` (B, S, …) rows at absolute `positions` (B, S) through the
    block table into `pool` ((P, page_size, …)), in place.  Masked /
    out-of-range rows — and rows aimed at an un-owned page or past the
    bound — are dropped.

    The lower bound matters: a negative position floor-divides to a
    negative page index (which passes `< n_pages`), clips to table entry 0,
    and `% page_size` wraps its row positive — without `positions >= 0` a
    stray padding row would land inside a live page.

    Dropping goes through `_scatter_drop`: no host sync, no extra page."""
    page, row, ok = paged_targets(positions, pv)
    vals = new.reshape((ok.shape[0],) + tuple(pool.shape[2:])).to(pool.dtype)
    return _scatter_drop(pool, (page, row), vals, ok)


def paged_targets(positions, pv: PagedKV):
    """(page, row, ok), each (B·S,) sequence-major: the pool row that each
    of the rows at `positions` (B, S) is written to through `pv`, and
    whether the write keeps it (`paged_update`'s rule).  The mesh Engine
    reads the rows a data rank wrote back through the same targets."""
    ps, mp = pv.page_size, pv.tables.shape[1]
    pg_idx = torch.div(positions, ps, rounding_mode="floor")
    ok = pv.write_mask[:, None] & (pg_idx < pv.n_pages[:, None]) \
        & (positions < pv.max_seq) & (positions >= 0)
    entry = pg_idx.clamp(0, mp - 1).long()
    if pv.owned is not None:
        ok = ok & torch.gather(pv.owned, 1, entry)
    if pv.bound is not None:
        ok = ok & (positions < pv.bound[:, None])
    page = torch.gather(pv.tables, 1, entry).reshape(-1).long()
    row = torch.remainder(positions, ps).reshape(-1).long()
    return page, row, ok.reshape(-1)


def _synced(cache, paged) -> None:
    """A paged layer's writes are done: hand its cache to the bundle's
    `sync` hook, if any."""
    if isinstance(paged, PagedKV) and paged.sync is not None:
        paged.sync(cache)


def paged_view(pool, pv: PagedKV):
    """Gather each sequence's pages into a dense (B, max_seq, …) view.
    Unallocated entries gather rows that sit at causally masked positions."""
    view = pool[pv.tables.clamp(0, pool.shape[0] - 1).long()]
    B = pv.tables.shape[0]
    view = view.reshape((B, -1) + tuple(pool.shape[2:]))
    return view[:, :pv.max_seq]


# ---------------------------------------------------------------------------
# core softmax attention
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask):
    """q: (B,Sq,H,hd) k/v: (B,Sk,Hkv,hd); mask: (Sq,Sk) or (B,1,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask.ndim == 2:
        mask = mask[None, None, None]
    else:
        mask = mask[:, :, None]                        # (B,1,1,Sq,Sk)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_attention(q, k, v, q_offset=0):
    """Query-chunked causal attention (training / prefill)."""
    Sq, Sk = q.shape[1], k.shape[1]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    outs = []
    for start in range(0, Sq, Q_CHUNK):
        n = min(Q_CHUNK, Sq - start)
        qpos = torch.arange(n, device=q.device)[:, None] + q_offset + start
        outs.append(_attend(q[:, start:start + n], k, v, kpos <= qpos))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def chunk_attention(q, k_cache, v_cache, positions):
    """Causal attention of a prefill chunk (or a decode step) at arbitrary
    absolute `positions` (B, Sq) against caches already holding its K/V."""
    Sk = k_cache.shape[1]
    mask = torch.arange(Sk, device=q.device)[None, None, :] \
        <= positions[:, :, None]                       # (B,Sq,Sk)
    return _attend(q, k_cache, v_cache, mask[:, None])


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode: q (B,1,H,hd); pos (B,) current positions."""
    return chunk_attention(q, k_cache, v_cache, pos[:, None])


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg, device):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.compute_dtype
    return {"wq": init_dense(gen, d, H * hd, dt, device),
            "wk": init_dense(gen, d, Hkv * hd, dt, device),
            "wv": init_dense(gen, d, Hkv * hd, dt, device),
            "wo": init_dense(gen, H * hd, d, dt, device)}


def gqa(p, x, cfg, positions, cache=None, cache_pos=None, paged=None):
    """cache: {"k","v"} (B, S_max, Hkv, hd), or (P, page_size, Hkv, hd)
    pools when a `PagedKV` bundle is passed, or None (train/prefill);
    int8 caches carry "ks"/"vs" row scales.  Returns (out, cache).  Under
    a tp-splitting mesh `cfg` is the rank's view (`sharding.local_config`:
    its H/n query and Hkv/n KV heads, whose `wo` rows it holds) and `wo`
    is row-parallel (`layers.dense_row`)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    x = column_input(x)
    q = dense(x, p["wq"], cfg.quant).reshape(B, S, H, hd)
    k = dense(x, p["wk"], cfg.quant).reshape(B, S, Hkv, hd)
    v = dense(x, p["wv"], cfg.quant).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    paged_kernel = isinstance(paged, PagedKV) and paged.decode_kernel \
        and S == 1
    if cache is None:
        out = causal_attention(q, k, v)
    elif "ks" in cache:                          # int8 KV cache (quant_kv)
        _update_cache_q(cache, k, v, cache_pos, paged, positions)
        _synced(cache, paged)
        if paged_kernel:
            # page-bounded decode kernel: the pool is read as stored int8
            # (q row-quantized exactly as decode_attention_q would)
            qq, qs = _quant_rows(q)
            out = pk.paged_decode_q(
                qq[:, 0].contiguous(), qs[:, 0].contiguous(), cache["k"],
                cache["ks"], cache["v"], cache["vs"], paged.tables,
                paged.n_pages, (positions[:, 0] + 1).to(torch.int32),
                q.dtype)[:, None]
        else:
            view = {key: paged_view(cache[key], paged) for key in cache} \
                if isinstance(paged, PagedKV) else cache
            out = decode_attention_q(q, view, positions)
    elif isinstance(paged, DenseKV):
        dense_update(cache["k"], k, positions, paged)
        dense_update(cache["v"], v, positions, paged)
        out = chunk_attention(q, cache["k"], cache["v"], positions)
    elif paged is not None:
        paged_update(cache["k"], k, positions, paged)
        paged_update(cache["v"], v, positions, paged)
        _synced(cache, paged)
        if paged_kernel:
            out = pk.paged_decode(q[:, 0].contiguous(), cache["k"],
                                  cache["v"], paged.tables, paged.n_pages,
                                  (positions[:, 0] + 1).to(torch.int32)
                                  )[:, None]
        else:
            out = chunk_attention(q, paged_view(cache["k"], paged),
                                  paged_view(cache["v"], paged), positions)
    else:
        _update_cache(cache["k"], k, cache_pos)
        _update_cache(cache["v"], v, cache_pos)
        out = chunk_attention(q, cache["k"], cache["v"], positions)
    return dense_row(out.reshape(B, S, H * hd), p["wo"], cfg.quant), cache


def _update_cache(cache, new, pos):
    """Write `new` (B,S,…) at per-batch start `pos` (B,), in place; like
    `dynamic_update_slice`, a start that would overflow is clamped."""
    B, S = new.shape[:2]
    start = pos.clamp(0, cache.shape[1] - S).long()
    rows = start[:, None] + torch.arange(S, device=new.device)[None]
    batch = torch.arange(B, device=new.device)[:, None].expand(B, S)
    cache[batch, rows] = new.to(cache.dtype)
    return cache


def init_gqa_cache(cfg, batch, max_seq, dtype, num_pages=None, device=None):
    """num_pages=None: dense (batch, max_seq, …) reservations; otherwise a
    shared paged pool of (num_pages, page_size, …)."""
    hd = cfg.hd
    if num_pages is None:
        shape = (batch, max_seq, cfg.num_kv_heads, hd)
        sshape = (batch, max_seq, cfg.num_kv_heads)
    else:
        shape = (num_pages, cfg.page_size, cfg.num_kv_heads, hd)
        sshape = (num_pages, cfg.page_size, cfg.num_kv_heads)
    if getattr(cfg, "quant_kv", False):
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.ones(sshape, dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "vs": torch.ones(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# int8 KV cache (quant_kv) — BRAMAC integer arithmetic inside attention
# ---------------------------------------------------------------------------

def _quant_rows(x):
    """Per-(…, head) row int8 quantization over the feature dim."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _update_cache_q(cache, k, v, pos, paged=None, positions=None):
    kq, ks = _quant_rows(k)
    vq, vs = _quant_rows(v)
    for key, val in (("k", kq), ("ks", ks), ("v", vq), ("vs", vs)):
        if isinstance(paged, DenseKV):
            dense_update(cache[key], val, positions, paged)
        elif paged is not None:
            paged_update(cache[key], val, positions, paged)
        else:
            _update_cache(cache[key], val, pos)
    return cache


def _int_einsum(eq, a, b):
    """Exact integer einsum via float64 (products and sums stay far below
    2^53); returns float64 holding integers."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64))


def decode_attention_q(q, cache, positions):
    """Attention over the int8 cache — decode (Sq=1) and offset prefill
    chunks alike; positions: (B, Sq) absolute query positions.  Q is
    row-quantized on the fly, K's scales factor out of the integer score
    dot, V's per-position scales fold into the probabilities, which are
    requantized to int8 for an integer PV dot."""
    B, Sq, H, hd = q.shape
    kc, ks, vc, vs = cache["k"], cache["ks"], cache["v"], cache["vs"]
    Sk, Hkv = kc.shape[1], kc.shape[2]
    group = H // Hkv
    qq, qs = _quant_rows(q)                              # (B,Sq,H,hd),(B,Sq,H)
    qg = qq.reshape(B, Sq, Hkv, group, hd)
    scores_i = _int_einsum("bqhgd,bkhd->bhgqk", qg, kc)
    qs_g = qs.reshape(B, Sq, Hkv, group).permute(0, 2, 3, 1)  # (B,Hkv,g,Sq)
    scores = scores_i.to(torch.float32) \
        * qs_g[..., None] * ks.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(hd)
    mask = (torch.arange(Sk, device=q.device)[None, None, :]
            <= positions[:, :, None])[:, None, None]     # (B,1,1,Sq,Sk)
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    pv = probs * vs.permute(0, 2, 1)[:, :, None, None, :]  # (B,Hkv,g,Sq,Sk)
    pq, pscale = _quant_rows(pv)
    out_i = _int_einsum("bhgqk,bkhd->bqhgd", pq, vc)
    out = out_i.to(torch.float32) \
        * pscale.permute(0, 3, 1, 2)[..., None]             # (B,Sq,Hkv,g,1)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3/DeepSeek style)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg, device):
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.compute_dtype
    return {"w_dq": init_dense(gen, d, qr, dt, device),
            "q_norm": init_rmsnorm(qr, dt, device),
            "w_uq": init_dense(gen, qr, H * (nope + rope), dt, device),
            "w_dkv": init_dense(gen, d, kvr, dt, device),
            "kv_norm": init_rmsnorm(kvr, dt, device),
            "w_kr": init_dense(gen, d, rope, dt, device),
            "w_uk": init_dense(gen, kvr, H * nope, dt, device),
            "w_uv": init_dense(gen, kvr, H * vd, dt, device),
            "wo": init_dense(gen, H * vd, d, dt, device)}


def mla(p, x, cfg, positions, cache=None, cache_pos=None, paged=None):
    """Latent attention; the cache holds only (c_kv, k_rope), written in
    place.  Every projection goes through the BRAMAC `dense`.  Under the
    paged layout the up-projections run over the gathered (B, max_seq)
    view, as the dense path runs them over its whole reservation; masked
    rows of the view are zeros.  The bundle's `decode_kernel` flag is
    ignored: MLA always reads through the gather.

    Under a tp-splitting mesh `cfg` is the rank's view (H/n heads): its
    `w_uq`, `w_uk` and `w_uv` hold this rank's heads' columns (contiguous
    head blocks, as each output reshapes to (..., H, .)), `wo` its rows
    (`layers.dense_row`), and `w_dq`, `w_dkv`, `w_kr` and the norms stay
    whole, so every rank writes the whole latent cache, which does not
    depend on the heads, into its own pool.  In training the latents
    (c_q, c_kv, k_rope) pass `layers.column_inputs` on their way to the
    rank's heads: the gradient sum over the axis stands there, after the
    whole projections, so `w_dq`, `w_dkv`, `w_kr` and the norms get their
    whole gradient on every rank (one sum a layer, of qr + kvr + rope
    values a token)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    c_q = rmsnorm(p["q_norm"], dense(x, p["w_dq"], cfg.quant), cfg.norm_eps)
    c_kv = rmsnorm(p["kv_norm"], dense(x, p["w_dkv"], cfg.quant),
                   cfg.norm_eps)
    # RoPE through a temporary head axis: (B, S, 1, rope) -> (B, S, rope)
    k_rope = apply_rope(dense(x, p["w_kr"], cfg.quant)[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]
    c_q, c_kv, k_rope = column_inputs(c_q, c_kv, k_rope)
    q = dense(c_q, p["w_uq"], cfg.quant).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    if cache is not None and isinstance(paged, DenseKV):
        dense_update(cache["c_kv"], c_kv, positions, paged)
        dense_update(cache["k_rope"], k_rope, positions, paged)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    elif cache is not None and paged is not None:
        paged_update(cache["c_kv"], c_kv, positions, paged)
        paged_update(cache["k_rope"], k_rope, positions, paged)
        _synced(cache, paged)
        c_kv = paged_view(cache["c_kv"], paged)
        k_rope = paged_view(cache["k_rope"], paged)
    elif cache is not None:
        _update_cache(cache["c_kv"], c_kv, cache_pos)
        _update_cache(cache["k_rope"], k_rope, cache_pos)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Sk = c_kv.shape[1]
    k_nope = dense(c_kv, p["w_uk"], cfg.quant).reshape(B, Sk, H, nope)
    v = dense(c_kv, p["w_uv"], cfg.quant).reshape(B, Sk, H, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, H, rope)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if cache is not None:                         # decode or prefill chunk
        out = chunk_attention(q_full, k, v, positions)
    else:
        out = causal_attention(q_full, k[:, :S], v[:, :S])
    return dense_row(out.reshape(B, S, H * vd), p["wo"], cfg.quant), cache


def init_mla_cache(cfg, batch, max_seq, dtype, num_pages=None, device=None):
    """The latent cache in the compute dtype (no int8 variant): dense
    (batch, max_seq, ...) reservations, or a (num_pages, page_size, ...)
    pool."""
    lead = (batch, max_seq) if num_pages is None \
        else (num_pages, cfg.page_size)
    return {"c_kv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype,
                                  device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (VLM: text queries attend to image patch embeddings)
# ---------------------------------------------------------------------------

def init_xattn(gen, cfg, device):
    return init_gqa(gen, cfg, device) | {
        "kv_norm": init_rmsnorm(cfg.d_model, cfg.compute_dtype, device)}


def xattn(p, x, cfg, vision_embeds, cache=None, cache_pos=None):
    """vision_embeds: (B, T_v, D) precomputed patch embeddings (the stub
    frontend).  K/V are position-free: a decode step (S == 1 with a cache)
    reads them from the cache, anything else projects them from
    `vision_embeds` and, given a cache, writes them there in place.
    Returns (out, cache).

    Under a tp-splitting ctx (training; the Engine serves no xattn arch)
    it is the GQA layer's tensor-parallel form: `cfg` is the rank's view
    (H/n query and Hkv/n KV heads), `wq` runs on `column_input(x)`, `wk`
    and `wv` on the whole normed vision embeddings, `wo` row-parallel
    (`layers.dense_row`).  `kv_norm` stays whole; each rank's backward
    reaches it through its own KV heads only, so its gradient is summed
    over the axis once a step (`runtime.trainer.model_partial`)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = dense(column_input(x), p["wq"], cfg.quant).reshape(B, S, H, hd)
    if cache is not None and S == 1:
        k, v = cache["k"], cache["v"]              # projected during prefill
    else:
        ve = rmsnorm(p["kv_norm"], vision_embeds, cfg.norm_eps)
        Tv = ve.shape[1]
        k = dense(ve, p["wk"], cfg.quant).reshape(B, Tv, Hkv, hd)
        v = dense(ve, p["wv"], cfg.quant).reshape(B, Tv, Hkv, hd)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _attend(q, k, v, mask)
    return dense_row(out.reshape(B, S, H * hd), p["wo"], cfg.quant), cache


def init_xattn_cache(cfg, batch, dtype, device=None):
    """Per-slot projected vision K/V, (batch, vision_tokens, Hkv, hd)."""
    shape = (batch, cfg.vision_tokens, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
