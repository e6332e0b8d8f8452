"""AdamW with optional block-wise int8-quantized moments (8-bit Adam).

Port of `repro.optim.adamw`.  The first moment is block-wise absmax int8
(`Q8`: 1 B/param plus one f32 scale per 128 values); the second moment
spans too many orders of magnitude for linear int8, so it is kept in
bfloat16, whose 8-bit exponent covers the range.  m+v: 8 → 3 bytes/param.

The reference dequantizes and updates whole trees at once.  Here `apply`
updates in place, leaf by leaf, and each leaf in flat slices of at most
`SLICE_ELEMS` values (a multiple of `BLOCK`), so the f32 temporaries are
one slice's, not the tree's: granite-8b's stacked w_gate alone
(36 x 4096 x 14336) would need ~34 GB of them.  Every step of the update
is elementwise and every slice boundary is a block boundary, so the
result is the same bit for bit whatever the slice size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.quant import Q8
from repro_torch.tree import tree_leaves, tree_map

BLOCK = 128
SLICE_ELEMS = BLOCK << 17          # 16.8 M values: ~67 MB per f32 temporary
NORM_CHUNK = 1 << 24               # global_norm's fixed summation chunks


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = True     # int8 m, bf16 v


# ---------------------------------------------------------------------------
# block-wise int8 state quantization
# ---------------------------------------------------------------------------

def _q8_blocks(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat f32 run (zero-padded to whole blocks)."""
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.round(blocks / scale).to(torch.int8)
    return q, scale.to(torch.float32)


def _q8(x: torch.Tensor) -> Q8:
    q, scale = _q8_blocks(x.reshape(-1).to(torch.float32))
    return Q8(q, scale, tuple(x.shape))


def _dq8(s: Q8) -> torch.Tensor:
    flat = (s.q.to(torch.float32) * s.scale).reshape(-1)
    return flat[:math.prod(s.shape)].reshape(s.shape)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments, built without the reference's f32 temporaries: a Q8 of
    zeros is int8 zeros with every scale at the 1e-12 floor."""
    def zeros_m(p):
        if not cfg.quantize_state:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        nb = -(-p.numel() // BLOCK)
        return Q8(torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
                  torch.full((nb, 1), 1e-12, dtype=torch.float32,
                             device=p.device), tuple(p.shape))

    def zeros_v(p):
        dt = torch.bfloat16 if cfg.quantize_state else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros_m, params), "v": tree_map(zeros_v, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32; each leaf is
    summed in fixed flat chunks, so no full-size f32 copy is made."""
    total = None
    for g in tree_leaves(grads):
        flat = g.reshape(-1)
        for s in range(0, flat.numel(), NORM_CHUNK):
            part = torch.sum(torch.square(
                flat[s:s + NORM_CHUNK].to(torch.float32)))
            total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply(params: Any, state: dict, grads: Any, cfg: AdamWConfig):
    """One AdamW step, in place on `params` and `state`.  Returns
    (params, state, {"grad_norm"})."""
    slice_elems = SLICE_ELEMS
    state["step"] += 1
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.full_like(step, cfg.b1), step)
    bc2 = 1 - torch.pow(torch.full_like(step, cfg.b2), step)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"]),
                          strict=True):
        decay = p.ndim >= 2                       # matrices only
        pf, gf, vf = p.view(-1), g.reshape(-1), v.view(-1)
        for s in range(0, pf.numel(), slice_elems):
            e = min(s + slice_elems, pf.numel())
            gs = gf[s:e].to(torch.float32) * clip
            if isinstance(m, Q8):
                b0, b1 = s // BLOCK, -(-e // BLOCK)
                ms = (m.q[b0:b1].to(torch.float32) * m.scale[b0:b1]
                      ).reshape(-1)[:e - s]
            else:
                ms = m.view(-1)[s:e]
            ms = cfg.b1 * ms + (1 - cfg.b1) * gs
            vs = cfg.b2 * vf[s:e].to(torch.float32) + (1 - cfg.b2) * gs * gs
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            ps = pf[s:e].to(torch.float32)
            if decay:
                delta = delta + cfg.weight_decay * ps
            pf[s:e] = (ps - cfg.lr * delta).to(p.dtype)
            vf[s:e] = vs.to(v.dtype)
            if isinstance(m, Q8):
                q, sc = _q8_blocks(ms)
                m.q[b0:b1] = q
                m.scale[b0:b1] = sc
            else:
                m.view(-1)[s:e] = ms
    return params, state, {"grad_norm": gnorm}


def lr_schedule(step, base_lr, warmup=100, total=10_000, min_frac=0.1):
    """Linear warmup + cosine decay, in f32 as the reference computes it."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(1.0, warmup)
    prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)
