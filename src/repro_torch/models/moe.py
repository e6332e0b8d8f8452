"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch, EP.

Port of `repro.models.moe`, with its expert-parallel routes: under an
active sharding ctx (`parallel.sharding.activate`, the mesh Engine, a
training rank) the quantized expert einsum goes through
`parallel.ep.ep_quant_einsum_edf`, the float expert stacks (training's)
run on this rank's block of the experts (`_expert_split`), and
`dispatch="per_source"` hands the whole layer to `parallel.ep.ep_moe`.
The first two are bit-exact against the meshless path.  Tokens are
scattered into a per-expert capacity buffer (E, C, d) — the
Switch-Transformer dispatch — so expert compute is E·C·(3·d·ff), about
the *active* FLOPs.  Serving weights run each expert einsum as one
`bramac_matmul` per expert (`bramac_linear.serve_einsum_edf`).

Router math is f32; a Switch-style load-balancing aux loss is returned.
Tokens overflowing an expert's capacity are dropped; every row of the call
routes and takes capacity, inactive slots and padded chunk positions
included, as in the reference.  Under a ctx whose forwards run a data
rank's block of the batch (`sharding.ShardingCtx.split_batch`, the mesh
Engine's slot split) the layer gathers its input over `data` first, runs
on the whole batch and keeps its block's rows: the reference takes the
expert einsum's input replicated over `data`, so routing and capacity see
every row of the call (a ZeRO-3 training rank too: the gather's backward
sums every rank's gradient of its rows, `comm.all_gather_grad`).
Nothing here reads a device value on the host: the scatter adds zeros
for dropped rows instead of masking them out.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import bramac_linear as bl
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.layers import he_init
from repro_torch.models.routing import (_one_hot, _rank_in_expert_cumsum,
                                        _rank_in_expert_sort, _top_k,
                                        dispatch_buffer, moe_capacity,
                                        router_top_k)
from repro_torch.parallel import comm, ep, sharding


def _expert_split(p, E: int):
    """(group, n, i) when the active ctx splits float expert stacks over
    an `expert` axis of n > 1 ranks that divides E (this rank holds block
    i of the experts: the training placement), else None.  The reference
    multiplies such stacks in one einsum that GSPMD shards; where n does
    not divide E its `constrain` leaves them whole, and so does the
    port."""
    ctx = sharding.active()
    if ctx is None or isinstance(p["w_gate"], QuantizedTensor):
        return None
    ax = ctx.phys_axis("expert")
    n = 1 if ax is None else ctx.mesh.shape[ax]
    if n == 1 or E % n:
        return None
    return ctx.mesh.group(ax), n, ctx.mesh.index(ax)


def _expert_matmul(x, w):
    """(E,C,a)·(E,a,b)→(E,C,b) for float or serving-quantized weights.  The
    reference calls the quantized einsum with its default 8-bit
    activations whatever `cfg.quant.bits_a` is; so does the port.

    Quantized weights route through the expert-parallel einsum whenever a
    sharding ctx is active and its `expert` axis divides E — bit-exact vs
    the single-rank path, so activation is a placement decision."""
    if isinstance(w, QuantizedTensor):
        ctx = sharding.active()
        if ctx is not None and ep.shardable(x, ctx):
            return ep.ep_quant_einsum_edf(x, w, mesh=ctx.mesh)
        return bl.serve_einsum_edf(x, w, transpose_out=False)
    return torch.einsum("ecd,edf->ecf", x, w)


def init_moe(gen, cfg, device):
    """The router and the three expert stacks, each stack drawn expert by
    expert into its (E, a, b) leaf, so the f32 draw never exceeds one
    expert's matrix (jamba's (16, 8192, 24576) stack would take 12.9 GB)."""
    d, ff, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    dt = cfg.compute_dtype

    def stack(a, b):
        w = torch.empty((E, a, b), dtype=dt, device=device)
        for e in range(E):
            w[e] = he_init(gen, (a, b), dt, device)
        return w
    return {"router": he_init(gen, (d, E), torch.float32, device),
            "w_gate": stack(d, ff), "w_up": stack(d, ff),
            "w_down": stack(ff, d)}


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, E) f32 router softmax
    top_p: torch.Tensor      # (T, k) f32, renormalised
    top_i: torch.Tensor      # (T, k) expert ids, descending probability
    a: torch.Tensor          # (T*k,) assignments, token-major
    pos_c: torch.Tensor      # (T*k,) row in the expert's buffer
    keep: torch.Tensor       # (T*k,) bool: within capacity
    C: int                   # rows per expert


def route(p, xf: torch.Tensor, cfg, capacity_factor: float) -> Routing:
    """The f32 router, top-k and the capacity dispatch of (T, d) rows."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    probs, top_p, top_i = router_top_k(xf, p["router"], k)
    C = moe_capacity(T, E, k, capacity_factor)
    a = top_i.reshape(T * k)
    rank = _rank_in_expert_sort if cfg.moe_dispatch == "sort" \
        else _rank_in_expert_cumsum
    pos = rank(a, E)
    keep = pos < C
    pos_c = torch.where(keep, pos, C - 1).long()
    return Routing(probs, top_p, top_i, a, pos_c, keep, C)


def moe(p, x, cfg, capacity_factor: float | None = None,
        dispatch: str | None = None):
    """x: (B, S, d) → (out, aux_loss).

    `capacity_factor` / `dispatch` default to `cfg.moe_capacity_factor` /
    `cfg.ep_dispatch`.  dispatch="per_source" hands the whole layer to
    `ep.ep_moe` when a sharding ctx is active and can token+expert-shard
    it, forwarding the caller's `capacity_factor`; without one it is the
    dense path below, as in the reference (per-source semantics at one
    shard)."""
    group = sharding.batch_group()
    if group is not None:
        # a data rank's block of the batch: route the whole batch
        n = x.shape[0]
        i = sharding.active().mesh.index("data")
        whole = comm.all_gather_grad(x, group, dim=0)
        with sharding.use(dataclasses.replace(sharding.active(),
                                              split_batch=False)):
            out, aux = moe(p, whole, cfg, capacity_factor, dispatch)
        return out[i * n:(i + 1) * n], aux
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if dispatch is None:
        dispatch = cfg.ep_dispatch
    if dispatch not in ("global", "per_source"):
        raise ValueError(f"ep_dispatch must be 'global' or 'per_source', "
                         f"got {dispatch!r}")
    if dispatch == "per_source":
        ctx = sharding.active()
        if ctx is not None and ep.layer_shardable(x, cfg, ctx):
            return ep.ep_moe(p, x, cfg, mesh=ctx.mesh,
                             capacity_factor=capacity_factor,
                             dispatch="per_source")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, d)
    r = route(p, xf, cfg, capacity_factor)

    # ---- capacity dispatch: dropped rows add zeros at (a, C-1) ----
    # under an expert split each rank's gradient of the buffer covers its
    # own experts: it is summed over the axis on the dispatch branch only
    # (the router's is whole on every rank already)
    split = _expert_split(p, E)
    xd = xf if split is None else comm.copy_to(xf, split[0])
    xk = torch.repeat_interleave(xd, k, dim=0)               # (T*k, d)
    buf = dispatch_buffer(E, r.C, r.a, r.pos_c, r.keep, xk)

    # ---- expert compute ----
    if split is not None:
        # this rank's E/n experts on their rows of the buffer, the
        # outputs gathered (backward: the rank's own block)
        group, n, i = split
        _, w = ep._moe_weights(p, E, n, i)
        ye = ep._expert_ffn(sharding.block(buf, 0, n, i), w,
                            quantized=False, bits_a=8)
        ye = comm.gather_from(ye, group, 0, i)               # (E, C, d)
    else:
        g = _expert_matmul(buf, p["w_gate"])
        u = _expert_matmul(buf, p["w_up"])
        ye = _expert_matmul(F.silu(g) * u, p["w_down"])

    # ---- combine ----
    yk = ye[r.a, r.pos_c]                                    # (T*k, d)
    w = (r.top_p.reshape(T * k).to(x.dtype) * r.keep.to(x.dtype))[:, None]
    out = torch.sum((yk * w).reshape(T, k, d), dim=1).reshape(B, S, d)

    # ---- Switch load-balance loss ----
    frac_tokens = torch.mean(_one_hot(r.top_i, E, torch.float32), dim=(0, 1))
    frac_probs = torch.mean(r.probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_reference(p, x, cfg):
    """Dense all-experts reference (exact, no drops) for tests."""
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    combine = torch.einsum("bske,bsk->bse",
                           _one_hot(top_i, E, torch.float32),
                           top_p).to(x.dtype)
    g = torch.einsum("bsd,edf->ebsf", x, p["w_gate"])
    u = torch.einsum("bsd,edf->ebsf", x, p["w_up"])
    ye = torch.einsum("ebsf,efd->ebsd", F.silu(g) * u, p["w_down"])
    return torch.einsum("ebsd,bse->bsd", ye, combine)
