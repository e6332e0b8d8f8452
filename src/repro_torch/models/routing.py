"""Top-k routing and capacity dispatch shared by the MoE layer
(`models.moe`) and its expert-parallel version (`parallel.ep`); the
reference's names, from `repro.models.moe`.

Router math is f32.  Nothing here reads a device value on the host:
one-hots compare instead of `F.one_hot`, ranks come from a stable sort and
a search instead of `bincount`, and dropped assignments add zeros.
"""
from __future__ import annotations

import torch


def moe_capacity(T: int, E: int, k: int, capacity_factor: float) -> int:
    """Per-expert buffer rows C — the one formula every dispatch path
    derives from."""
    return int(max(1, round(T * k / E * capacity_factor)))


def _one_hot(i: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """one_hot by comparison (F.one_hot validates its input on the host)."""
    return (i[..., None] == torch.arange(E, device=i.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k`: descending, ties to the lower index (a stable sort;
    `torch.topk` promises no order among ties)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def router_top_k(xf: torch.Tensor, router: torch.Tensor, k: int):
    """The f32 router softmax of (T, d) rows and its top k, renormalised:
    (probs (T, E), top_p (T, k), top_i (T, k))."""
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_p, top_i = _top_k(probs, k)
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_i


def dispatch_buffer(E: int, rows: int, a, pos_c, keep, vals):
    """(E, rows, ...) capacity buffer with `vals` added at (a, pos_c) where
    kept: dropped assignments add zeros at their clamped row, so nothing
    is read on the host."""
    buf = torch.zeros((E, rows) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    keep = keep.reshape((-1,) + (1,) * (vals.ndim - 1))
    buf.index_put_((a, pos_c), torch.where(keep, vals, 0), accumulate=True)
    return buf


def _rank_in_expert_cumsum(a: torch.Tensor, E: int) -> torch.Tensor:
    """The one-hot running-count rank (moe_dispatch="cumsum")."""
    onehot = _one_hot(a, E, torch.int32)                     # (T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(pos_in_e, 1, a.long()[:, None])[:, 0]


def _rank_in_expert_sort(a: torch.Tensor, E: int) -> torch.Tensor:
    """pos[i] = #{j : a[j] == a[i], j before i}: stable-sort the
    assignments, rank each within its expert's run (index − the run's
    start, found by a search of the sorted ids: `bincount` would size its
    output on the host), scatter the ranks back."""
    n = a.shape[0]
    order = torch.argsort(a, stable=True)                    # expert-major
    sorted_a = a[order].contiguous()
    starts = torch.searchsorted(sorted_a, sorted_a)
    rank_sorted = torch.arange(n, device=a.device) - starts
    pos = torch.zeros((n,), dtype=torch.int32, device=a.device)
    pos[order] = rank_sorted.to(torch.int32)
    return pos
