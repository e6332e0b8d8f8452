"""Paged-KV decode attention: CUDA kernel wrappers and plain versions.

`paged_decode` replaces the Pallas TPU kernel
`repro/kernels/paged_attention.py::_fp_kernel` (pallas_call at :214) and
`paged_decode_q` replaces `::_q_kernel` (pallas_call at :258).  The CUDA
sources are in `csrc/paged_attention.cu`, whose header note gives the H100
bound (live KV bytes) and the design.

Contract (the reference's): each sequence reads only the
``min(n_pages[b], ceil(length[b] / page_size))`` pages its block table
lists, scores are fp32 and divided by sqrt(hd), rows at or past the length
are masked to -1e30, a sequence with ``n_pages == 0`` returns zeros, and
the int8 variant keeps the cache int8 and replays
`attention.decode_attention_q`'s arithmetic (probabilities requantized to
int8 before an integer PV dot).

Both kernels split each sequence's page walk over a thread block cluster
of up to 8 blocks; `_split` picks the split from `max_pages` alone
(host-known), never from the lengths, which live on the device.  `_plan_fp`
adds the fp kernel's ring tile, `_plan_q` whether the int8 kernel's scores
spill to a device scratch buffer.

CPU tensors take the plain versions below; CUDA tensors launch the kernels
or raise.  The plain versions gather the table's pages into a padded view
and mask every row outside the walked pages — the same function, summed
in another order, so they agree with the kernels to fp32 reassociation.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_KV_DTYPES = (torch.float32, torch.bfloat16)
MAX_SPLITS = 8                 # blocks of one cluster: the portable size
Q_SMEM_LIMIT = 96 * 1024       # scores stay in shared memory up to this
FP_TILE_BYTES = 16384          # bytes of one K tile of the ring, at most


def _split(max_pages: int) -> tuple[int, int]:
    """-> (splits, pages_per_split): each (sequence, KV head) gets a cluster
    of `splits` <= MAX_SPLITS blocks, and block s walks table pages
    [s * pages_per_split, (s + 1) * pages_per_split), so every block's
    range starts inside the table."""
    splits = max(1, min(MAX_SPLITS, max_pages))
    pps = max(1, -(-max_pages // splits))
    return max(1, -(-max_pages // pps)), pps


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _plan_fp(max_pages: int, hd: int,
             kv_itemsize: int) -> tuple[int, int, int]:
    """Launch plan of the fp kernel -> (splits, pages_per_split, tile).

    The split is `_split`'s; `tile` is the rows of one ring stage: 32 (a
    row per lane), or 16 where a 32-row K tile would pass FP_TILE_BYTES
    (hd * itemsize > 512).  Only host-known sizes enter: no length."""
    splits, pps = _split(max_pages)
    tile = 32 if 32 * _up16(hd * kv_itemsize) <= FP_TILE_BYTES else 16
    return splits, pps, tile


def _q_smem(g: int, hd: int, rows: int, scratch: bool) -> int:
    """Dynamic shared memory of one int8 block (as the kernel lays it out):
    q padded to 16-byte chunks, 5 per-head floats padded to 16 bytes, the
    int32 PV tile, then, without scratch, the (g + 1, rows) f32 scores and
    V row scales."""
    ncp = 1 << (-(-hd // 16) - 1).bit_length()
    fixed = g * ncp * 16 + 4 * (5 * g + (-5 * g) % 4) + 4 * g * hd
    return fixed + (0 if scratch else 4 * (g + 1) * rows)


def _plan_q(max_pages: int, page_size: int, g: int,
            hd: int) -> tuple[int, int, bool]:
    """Launch plan of the int8 kernel -> (splits, pages_per_split, scratch).

    The split is `_split`'s.  The scores of a block's rows live in shared
    memory unless that would pass Q_SMEM_LIMIT; then `scratch`, and the
    wrapper allocates them in device memory.  Only host-known sizes enter:
    no length."""
    splits, pps = _split(max_pages)
    return splits, pps, _q_smem(g, hd, pps * page_size, False) > Q_SMEM_LIMIT


def _gather_valid(tables, n_pages, lengths, page_size, P):
    """Row validity (B, max_pages*ps) of the walked pages, and the clipped
    table for gathering."""
    B, mp = tables.shape
    rows = torch.arange(mp * page_size, device=tables.device)[None]
    valid = (rows < lengths[:, None]) \
        & (rows // page_size < n_pages[:, None])
    return valid, tables.clamp(0, max(P - 1, 0)).long()


def _view(pool, tbl):
    """(P, ps, Hkv, ...) gathered through (B, mp) → (B, mp*ps, Hkv, ...)."""
    B = tbl.shape[0]
    return pool[tbl].reshape((B, -1) + tuple(pool.shape[2:]))


def paged_decode_plain(q, k_pool, v_pool, tables, n_pages, lengths):
    """Plain PyTorch version of `paged_decode` (same inputs/outputs)."""
    B, H, hd = q.shape
    P, ps, Hkv = k_pool.shape[:3]
    g = H // Hkv
    valid, tbl = _gather_valid(tables, n_pages, lengths, ps, P)
    k = _view(k_pool, tbl).to(torch.float32)               # (B, S, Hkv, hd)
    v = _view(v_pool, tbl).to(torch.float32)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qg = q.to(torch.float32).reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid[:, None, None, :], torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    out = out / torch.where(l > 0, l, 1.0)
    return out.reshape(B, H, hd).to(q.dtype)


def _q_plain(q_int8, q_scale, k_pool, k_scales, v_pool, v_scales, tables,
             n_pages, lengths, out_dtype):
    """Plain int8 decode; returns (out, pscale (B, H)) — the probability
    row scale bounds what one rounding flip can change."""
    B, H, hd = q_int8.shape
    P, ps, Hkv = k_pool.shape[:3]
    g = H // Hkv
    valid, tbl = _gather_valid(tables, n_pages, lengths, ps, P)
    vmask = valid[:, None, None, :]
    kq = _view(k_pool, tbl).to(torch.float64)               # (B, S, Hkv, hd)
    vq = _view(v_pool, tbl).to(torch.float64)
    ks = _view(k_scales, tbl).permute(0, 2, 1)[:, :, None]  # (B, Hkv, 1, S)
    vs = _view(v_scales, tbl).permute(0, 2, 1)[:, :, None]
    qg = q_int8.to(torch.float64).reshape(B, Hkv, g, hd)
    # integer score dot, exact in float64
    s_i = torch.einsum("bhgd,bshd->bhgs", qg, kq).to(torch.float32)
    qs = q_scale.to(torch.float32).reshape(B, Hkv, g, 1)
    s = s_i * qs * ks / math.sqrt(hd)
    s = torch.where(vmask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(vmask, torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    u = torch.where(vmask, e * vs, 0.0).amax(dim=-1, keepdim=True)
    l = torch.where(l > 0, l, 1.0)
    pscale = torch.clamp(u / l, min=1e-6) / 127.0
    p = torch.where(vmask, e / l * vs, 0.0)
    pq = torch.clamp(torch.round(p / pscale), -127, 127)
    acc = torch.einsum("bhgs,bshd->bhgd", pq.to(torch.float64), vq)
    out = acc.to(torch.float32) * pscale
    return out.reshape(B, H, hd).to(out_dtype), pscale.reshape(B, H)


def paged_decode_q_plain(q_int8, q_scale, k_pool, k_scales, v_pool, v_scales,
                         tables, n_pages, lengths, out_dtype):
    """Plain PyTorch version of `paged_decode_q` (same inputs/outputs)."""
    return _q_plain(q_int8, q_scale, k_pool, k_scales, v_pool, v_scales,
                    tables, n_pages, lengths, out_dtype)[0]


def _check_common(q, pools, tables, n_pages, lengths):
    B, H, hd = q.shape
    P, ps, Hkv, hd_k = pools[0].shape
    for p in pools:
        if tuple(p.shape[:3]) != (P, ps, Hkv):
            raise ValueError("pools must share (P, page_size, Hkv)")
    if hd_k != hd or H % Hkv:
        raise ValueError(f"q (B,H,hd)={tuple(q.shape)} does not match pool "
                         f"{tuple(pools[0].shape)}")
    if tables.dtype != torch.int32 or n_pages.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("tables, n_pages and lengths must be int32")
    if tables.ndim != 2 or tables.shape[0] != B or n_pages.shape != (B,) \
            or lengths.shape != (B,):
        raise ValueError("tables (B, max_pages), n_pages and lengths (B,)")
    if H // Hkv > 16 or hd > 256:
        raise ValueError(f"the CUDA kernel takes H/Hkv <= 16 and hd <= 256, "
                         f"got {H // Hkv} and {hd}")
    return B, H, hd, P, ps, Hkv


def _on_cuda(*tensors) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("operands must all be on one CUDA device (or all "
                         "on the CPU)")
    return True


def _contig(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("paged decode kernels take contiguous tensors")


def paged_decode(q, k_pool, v_pool, tables, n_pages, lengths):
    """Decode attention straight off the paged pool (fp K/V).

    q: (B, H, hd) roped queries; pools: (P, page_size, Hkv, hd);
    tables: (B, max_pages) i32; n_pages: (B,) i32; lengths: (B,) i32 rows
    each query attends (``position + 1``).  Returns (B, H, hd) in q.dtype.
    """
    B, H, hd, P, ps, Hkv = _check_common(q, (k_pool, v_pool), tables,
                                         n_pages, lengths)
    if q.dtype not in _KV_DTYPES or k_pool.dtype not in _KV_DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_decode takes f32/bf16 q and pools, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if not _on_cuda(q, k_pool, v_pool, tables, n_pages, lengths):
        return paged_decode_plain(q, k_pool, v_pool, tables, n_pages, lengths)
    _contig(q, k_pool, v_pool, tables, n_pages, lengths)
    out = torch.empty_like(q)
    if B == 0:
        return out
    max_pages = tables.shape[1]
    splits, pps, tile = _plan_fp(max_pages, hd, k_pool.element_size())
    lib = build.library("paged_attention")
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        n_pages.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, Hkv,
        hd, ps, max_pages, splits, pps, tile, int(q.dtype == torch.bfloat16),
        int(k_pool.dtype == torch.bfloat16), math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


def paged_decode_q(q_int8, q_scale, k_pool, k_scales, v_pool, v_scales,
                   tables, n_pages, lengths, out_dtype):
    """int8-KV decode attention off the quantized pool.

    q_int8/q_scale: (B, H, hd) int8 + (B, H) f32 row-quantized queries
    (`attention._quant_rows`); k/v pools: (P, page_size, Hkv, hd) int8 with
    (P, page_size, Hkv) f32 row scales.  Returns (B, H, hd) `out_dtype`."""
    B, H, hd, P, ps, Hkv = _check_common(q_int8, (k_pool, v_pool), tables,
                                         n_pages, lengths)
    if q_int8.dtype != torch.int8 or k_pool.dtype != torch.int8 \
            or v_pool.dtype != torch.int8:
        raise TypeError("paged_decode_q takes int8 q and pools")
    for s, shape in ((q_scale, (B, H)), (k_scales, (P, ps, Hkv)),
                     (v_scales, (P, ps, Hkv))):
        if s.dtype != torch.float32 or tuple(s.shape) != shape:
            raise ValueError(f"scales must be f32 {shape}, got {s.dtype} "
                             f"{tuple(s.shape)}")
    if out_dtype not in _KV_DTYPES:
        raise TypeError(f"out_dtype must be one of {_KV_DTYPES}")
    args = (q_int8, q_scale, k_pool, k_scales, v_pool, v_scales, tables,
            n_pages, lengths)
    if not _on_cuda(*args):
        return paged_decode_q_plain(*args, out_dtype)
    _contig(*args)
    out = torch.empty((B, H, hd), dtype=out_dtype, device=q_int8.device)
    if B == 0:
        return out
    max_pages, g = tables.shape[1], H // Hkv
    splits, pps, scratch = _plan_q(max_pages, ps, g, hd)
    buf = torch.empty((B * Hkv * splits * (g + 1) * pps * ps,),
                      dtype=torch.float32, device=q_int8.device) \
        if scratch else None
    lib = build.library("paged_attention")
    err = lib.paged_decode_q_launch(
        *(t.data_ptr() for t in args), out.data_ptr(),
        None if buf is None else buf.data_ptr(), B, H, Hkv, hd, ps,
        max_pages, splits, pps, int(out_dtype == torch.bfloat16),
        math.sqrt(hd), torch.cuda.current_stream(q_int8.device).cuda_stream)
    build.check(err, "paged_decode_q")
    paged_decode_q.launches += 1
    return out


paged_decode.launches = 0
paged_decode_q.launches = 0


# ---------------------------------------------------------------------------
# KV bytes-read accounting (the decode-microbenchmark currency)
# ---------------------------------------------------------------------------

def kv_row_bytes(cfg) -> int:
    """Bytes one decode step reads per cached KV row, summed over every
    layer that owns a paged pool (attn: K+V heads, int8 rows carry their
    f32 scales; mla: the latent c_kv + k_rope row; xattn/recurrent layers
    hold no paged pool and contribute nothing)."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    total = 0
    for spec in cfg.layer_pattern:
        if "mla" in spec:
            total += (cfg.kv_lora_rank + cfg.qk_rope_dim) * itemsize
        elif "attn" in spec and "xattn" not in spec:
            if getattr(cfg, "quant_kv", False):
                total += 2 * cfg.num_kv_heads * (cfg.hd + 4)  # int8 + f32
            else:
                total += 2 * cfg.num_kv_heads * cfg.hd * itemsize
    return total * cfg.n_periods


def decode_read_rows(lengths, page_size: int) -> int:
    """Pool rows ONE decode step touches under the kernel: each live
    sequence reads its pages up to the one holding its last row."""
    return sum(-(-int(n) // page_size) * page_size for n in lengths if n > 0)


def oracle_read_rows(num_slots: int, max_seq: int) -> int:
    """Pool rows ONE decode step touches under the gather oracle: every
    slot's table materialized to max_seq rows, live or not."""
    return num_slots * max_seq
