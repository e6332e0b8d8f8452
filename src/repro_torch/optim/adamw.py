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

On a training mesh each rank updates its own block of every split leaf
(`splits`: {path: `sharding.Split`}, cut over `model`, over `data` by
ZeRO-3, or both; `groups`: {mesh axis: process group}).  The global norm
sums each leaf's squares over every axis it is cut over (one `all_reduce`
an axis, for all the leaves cut over it) and counts a leaf once along the
axes it is whole on.  The int8 first moment keeps the whole leaf's block
grid, so the update equals the meshless one bit for bit and a checkpoint
holds the reference's layout whatever the mesh:
  * a block whose 128 values all lie on one rank (every block of a leaf
    whose runs, `Split.run`, are whole blocks: granite-8b at full width
    on model=2, data=2 or both) is updated locally, and the rank's Q8 is
    the ordinary one of its block, whose blocks are the whole leaf's;
  * otherwise (the smoke widths: wq's 32 local columns of 64) the rank
    keeps its values in its own flat order, (ceil(local/128), 128), and
    the whole leaf's scales, (n_blocks, 1); each step's new block absmax
    is the max of every rank's partial one: one `all_reduce` max an axis
    for all such leaves cut over it.
`gather_q` / `gather_scale` and `take_q` / `take_scale` convert a rank's
Q8 to the whole leaf's and back (checkpoints).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.quant import Q8
from repro_torch.parallel import comm
from repro_torch.tree import tree_items, tree_leaves, tree_map_with_path

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

def _blocked(flat: torch.Tensor) -> torch.Tensor:
    """A flat run as (n_blocks, BLOCK), zero-padded to whole blocks."""
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def _q8_blocks(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat f32 run (zero-padded to whole blocks)."""
    blocks = _blocked(flat)
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

def _spread(s) -> bool:
    """Whether a leaf split `s` has blocks that span ranks."""
    return s is not None and s.run % BLOCK != 0


def _n_blocks(numel: int) -> int:
    return -(-numel // BLOCK)


def init(params: Any, cfg: AdamWConfig, splits: dict | None = None) -> dict:
    """Zero moments, built without the reference's f32 temporaries: a Q8 of
    zeros is int8 zeros with every scale at the 1e-12 floor.  A leaf whose
    split spreads blocks over ranks keeps the whole leaf's scales."""
    splits = splits or {}

    def zeros_m(path, p):
        if not cfg.quantize_state:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        s = splits.get(path)
        ns = _n_blocks(math.prod(s.whole)) if _spread(s) else \
            _n_blocks(p.numel())
        return Q8(torch.zeros((_n_blocks(p.numel()), BLOCK), dtype=torch.int8,
                              device=p.device),
                  torch.full((ns, 1), 1e-12, dtype=torch.float32,
                             device=p.device), tuple(p.shape))

    def zeros_v(p):
        dt = torch.bfloat16 if cfg.quantize_state else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map_with_path(zeros_m, params),
            "v": tree_map_with_path(lambda _, p: zeros_v(p), params)}


def _over_axes(parts: dict, groups, op: str) -> dict:
    """{axes: tensor} with each tensor reduced (`op`) over every mesh axis
    of its key: one `all_reduce` an axis, of all the tensors whose key
    holds it, packed."""
    for axis in sorted({a for key in parts for a in key}):
        keys = [k for k in parts if axis in k]
        red = comm.all_reduce(torch.cat([parts[k].reshape(-1) for k in keys]),
                              (groups or {}).get(axis), op)
        for k, r in zip(keys, torch.split(red, [parts[k].numel()
                                                for k in keys])):
            parts[k] = r.reshape(parts[k].shape)
    return parts


def global_norm(grads, splits: dict | None = None, groups=None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32; each leaf is
    summed in fixed flat chunks, so no full-size f32 copy is made.  With
    `splits`, the sums of the leaves cut over some mesh axes are reduced
    over those axes (`groups`: {axis: group}) and every leaf is counted
    once along the axes it is whole on."""
    splits = splits or {}
    total = {}                      # by: the axes the leaf is cut over
    for path, g in tree_items(grads):
        s = splits.get(path)
        key = () if s is None else s.axes
        flat = g.reshape(-1)
        for c in range(0, flat.numel(), NORM_CHUNK):
            part = torch.sum(torch.square(
                flat[c:c + NORM_CHUNK].to(torch.float32)))
            total[key] = part if key not in total else total[key] + part
    total = _over_axes({k: total[k].reshape(1) for k in sorted(total)},
                       groups, "sum")
    out = None
    for k in sorted(total):
        out = total[k][0] if out is None else out + total[k][0]
    return torch.sqrt(out)


def _m_run(cfg, m: Q8, gs, s, e, blk):
    """The new first moment of flat positions [s, e) in f32: `m`'s int8
    values there times their blocks' scales (`blk`: the positions' rows of
    `m.scale`, None when they are `m`'s own rows), moved by `gs`."""
    if blk is None:
        b0, b1 = s // BLOCK, -(-e // BLOCK)
        old = (m.q[b0:b1].to(torch.float32) * m.scale[b0:b1]).reshape(-1)[
            :e - s]
    else:
        old = m.q.view(-1)[s:e].to(torch.float32) * m.scale.view(-1)[blk]
    return cfg.b1 * old + (1 - cfg.b1) * gs


def _blocks_of(split, s, e, device) -> torch.Tensor:
    """The whole leaf's block of each of this rank's flat positions
    [s, e)."""
    j = torch.arange(s, e, device=device)
    return torch.div(split.whole_index(j), BLOCK, rounding_mode="floor")


def _spread_amax(cfg, leaves, clip, groups) -> list:
    """For each leaf (g, m, split) whose blocks span ranks: the whole
    leaf's new block absmax, each rank's partial maxima reduced over the
    axes the leaf is cut over (one `all_reduce` max an axis for all the
    leaves cut over it)."""
    parts = {}
    for j, (g, m, split) in enumerate(leaves):
        gf = g.reshape(-1)
        amax = torch.zeros(_n_blocks(math.prod(split.whole)),
                           dtype=torch.float32, device=g.device)
        for s in range(0, gf.numel(), SLICE_ELEMS):
            e = min(s + SLICE_ELEMS, gf.numel())
            blk = _blocks_of(split, s, e, g.device)
            ms = _m_run(cfg, m, gf[s:e].to(torch.float32) * clip, s, e,
                        blk)
            amax.scatter_reduce_(0, blk, torch.abs(ms), "amax")
        parts.setdefault(split.axes, []).append((j, amax))
    packed = _over_axes({k: torch.cat([a for _, a in v])
                         for k, v in parts.items()}, groups, "max")
    out = [None] * len(leaves)
    for k, v in parts.items():
        for (j, _), a in zip(v, torch.split(packed[k],
                                            [a.numel() for _, a in v])):
            out[j] = a
    return out


@torch.no_grad()
def apply(params: Any, state: dict, grads: Any, cfg: AdamWConfig,
          splits: dict | None = None, groups=None):
    """One AdamW step, in place on `params` and `state`.  Returns
    (params, state, {"grad_norm"}).  `splits` ({path: Split}) and `groups`
    ({mesh axis: process group}, a mesh's `groups`) describe a training
    rank's tree."""
    splits = splits or {}
    slice_elems = SLICE_ELEMS
    state["step"] += 1
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads, splits, groups)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.full_like(step, cfg.b1), step)
    bc2 = 1 - torch.pow(torch.full_like(step, cfg.b2), step)

    rows = list(zip(tree_items(params), tree_leaves(grads),
                    tree_leaves(state["m"]), tree_leaves(state["v"]),
                    strict=True))
    spread = []
    for (path, _), g, m, _ in rows:
        split = splits.get(path)
        if not (isinstance(m, Q8) and _spread(split)):
            continue
        whole = _n_blocks(math.prod(split.whole))
        if m.scale.shape[0] != whole:
            raise ValueError(
                f"{path}: its int8 first moment holds {m.scale.shape[0]} "
                f"block scales, not the whole leaf's {whole}: this rank's "
                f"blocks span ranks, so it keeps the whole leaf's grid "
                f"(adamw.init with the splits)")
        spread.append((g, m, split))
    amaxes = iter(_spread_amax(cfg, spread, clip, groups))
    for (path, p), g, m, v in rows:
        decay = p.ndim >= 2                       # matrices only
        split = splits.get(path)
        new_scale = None
        if isinstance(m, Q8) and _spread(split):
            new_scale = torch.clamp(next(amaxes) / 127.0, min=1e-12)
        pf, gf, vf = p.view(-1), g.reshape(-1), v.view(-1)
        for s in range(0, pf.numel(), slice_elems):
            e = min(s + slice_elems, pf.numel())
            gs = gf[s:e].to(torch.float32) * clip
            blk = None if new_scale is None else \
                _blocks_of(split, s, e, p.device)
            if isinstance(m, Q8):
                ms = _m_run(cfg, m, gs, s, e, blk)
            else:
                ms = cfg.b1 * m.view(-1)[s:e] + (1 - cfg.b1) * gs
            vs = cfg.b2 * vf[s:e].to(torch.float32) + (1 - cfg.b2) * gs * gs
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            ps = pf[s:e].to(torch.float32)
            if decay:
                delta = delta + cfg.weight_decay * ps
            pf[s:e] = (ps - cfg.lr * delta).to(p.dtype)
            vf[s:e] = vs.to(v.dtype)
            if blk is not None:
                m.q.view(-1)[s:e] = torch.round(
                    ms / new_scale[blk]).to(torch.int8)
            elif isinstance(m, Q8):
                b0, b1 = s // BLOCK, -(-e // BLOCK)
                m.q[b0:b1], m.scale[b0:b1] = _q8_blocks(ms)
            else:
                m.view(-1)[s:e] = ms
        if new_scale is not None:
            m.scale.copy_(new_scale.view(-1, 1))
    return params, state, {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# a training rank's first moment <-> the whole leaf's
# ---------------------------------------------------------------------------

def gather_q(q: torch.Tensor, split, gather) -> torch.Tensor:
    """The whole leaf's int8 blocks from this rank's: its values in its
    block's shape, joined cut by cut by `gather(t, cut)`."""
    local = q.reshape(-1)[:math.prod(split.local)].reshape(split.local)
    return _blocked(split.join(local, gather).reshape(-1))


def gather_scale(scale: torch.Tensor, split, gather) -> torch.Tensor:
    """The whole leaf's block scales: a rank whose blocks are the whole
    leaf's holds its block of the leaf's block grid (`Split.grid`), joined
    across ranks; a rank of a spread leaf holds them all."""
    if _spread(split):
        return scale
    grid = split.grid(BLOCK)
    return grid.join(scale.reshape(grid.local), gather).reshape(-1, 1)


def take_q(q: torch.Tensor, split) -> torch.Tensor:
    whole = q.reshape(-1)[:math.prod(split.whole)].reshape(split.whole)
    return _blocked(split.take(whole).reshape(-1))


def take_scale(scale: torch.Tensor, split) -> torch.Tensor:
    if _spread(split):
        return scale
    grid = split.grid(BLOCK)
    return grid.take(scale.reshape(grid.whole)).reshape(-1, 1)


def lr_schedule(step, base_lr, warmup=100, total=10_000, min_frac=0.1):
    """Linear warmup + cosine decay, in f32 as the reference computes it."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(1.0, warmup)
    prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)
