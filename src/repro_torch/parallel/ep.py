"""Expert-parallel quantized einsum and MoE layer — §VI many-tile scale-out
for MoE (port of `repro.parallel.ep`).

The MoE expert matmul is a batched (E, C, d)·(E, d, f) einsum.  Two ways to
cut it across a mesh, both bit-exact against the single-rank serving path
(`bl.serve_einsum_edf`) because every cross-rank reduction happens on the
int32 accumulator before the one dequant epilogue:

  * **partition="e" (expert-parallel)** — each rank owns E/n experts (the
    weight slices `sharding.shard_params` places on the `model` axis) and
    the matching capacity-buffer slices, and runs them through
    `bl.serve_einsum_edf` (one `bramac_matmul` per local expert).  No
    reduction: exactness is structural; an `all_gather` assembles E.
  * **partition="d" (contraction-parallel)** — activations are quantized
    *globally* (per (e,c) row over the full d), each rank multiplies its
    d-slice with `bl.edf_accumulate`'s exact integer product (not the
    kernel's int32 mode, which rounds above 2^24 where the reference's
    `dot_general` does not), and an integer `all_reduce` joins the
    partials.

Both compose with a `dp_axis` that also shards the capacity axis C.
Callers pass the full logical operands; weights may also arrive already
placed (E/n experts, or d/n rows on "d"), as the Engine's sharded tree
holds them — each rank takes its block of whatever is whole.

`ep_moe` is the full expert-parallel MoE layer (tokens AND experts split
over the EP axis) with two token dispatch modes:

  * **dispatch="global"** — exact: the *global* rank-in-expert comes from
    an all-gathered per-rank count scan; every source scatters into full
    (E, C, d) capacity buffers that an `all_to_all` delivers and the owner
    sums; the combine `all_gather`s the expert outputs.  Bit-exact vs the
    single-rank `moe()`, drops included.
  * **dispatch="per_source"** — the GShard-style lossy fast path: each
    source packs at most `C_src = ceil(C / n)` tokens per destination
    expert (values plus an int32 sidecar of expert id / source rank /
    validity), one `all_to_all` delivers them, experts compute on the
    concatenated per-source rows, and a mirrored `all_to_all` sends the
    results back.  Drops are decided shard-locally, in (token, k-slot)
    order; `per_source_reference` replays exactly this rule on one rank.

The input x is replicated on every rank of the axis (as in the Engine);
each rank takes its T/n token block and the outputs are gathered back.

`ep_moe` trains: autograd passes through each of its collectives with
the backward that fits how its result is used, for a loss that every
rank of the axis computes alike.  x and the router enter through
`comm.copy_to` (each rank's gradient covers its own token rows only, and
the rows are disjoint, so the sum over the axis is the whole gradient);
the `all_to_all`s are their own transposes; the global combine's
`all_gather` reduce-scatters its gradient back to the owners
(`comm.all_gather_grad`: every source reads the rows of its own
tokens); the gather of `out` hands each rank its own block
(`comm.gather_from`) and the `frac_probs` sum passes its gradient
through (`comm.reduce_from`), since everything after them is
replicated.  Counts, the sidecar and `frac_tokens` are integer or
one-hot and carry none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bramac_linear as bl
from repro_torch.core import quant
from repro_torch.kernels import ref
from repro_torch.models.routing import (_one_hot, _rank_in_expert_sort,
                                        dispatch_buffer, moe_capacity,
                                        router_top_k)
from repro_torch.parallel import comm, sharding


def _ep_axis(mesh, axis: str | None) -> str:
    """Resolve the physical EP axis: explicit arg > active `expert` rule >
    "model"."""
    if axis is not None:
        return axis
    ctx = sharding.active()
    if ctx is not None:
        phys = ctx.phys_axis("expert")
        if phys is not None:
            return phys
    return "model"


def shardable(x: torch.Tensor, ctx=None) -> bool:
    """True when the active (or given) sharding ctx can expert-shard an
    (E, C, d) buffer: a string `expert` rule whose mesh axis divides E."""
    ctx = ctx or sharding.active()
    if ctx is None:
        return False
    phys = ctx.phys_axis("expert")
    if phys is None:
        return False
    return x.shape[0] % ctx.mesh.shape[phys] == 0


def layer_shardable(x: torch.Tensor, cfg, ctx=None) -> bool:
    """True when the full `ep_moe` layer can run under the active (or
    given) ctx for a (B, S, d) input: the `expert` rule resolves to one
    mesh axis whose size divides both E and T = B·S."""
    ctx = ctx or sharding.active()
    if ctx is None:
        return False
    phys = ctx.phys_axis("expert")
    if phys is None:
        return False
    n = ctx.mesh.shape[phys]
    B, S = x.shape[0], x.shape[1]
    return cfg.num_experts % n == 0 and (B * S) % n == 0


def _local(w, dim, full, n, i):
    """Rank i's block of `w` (a tensor, or a QuantizedTensor by its stored
    values) along `dim` when `w` is whole there (`full` long), `w` itself
    when it is already placed (full/n long)."""
    qt = isinstance(w, quant.QuantizedTensor)
    size = (w.values if qt else w).shape[dim]
    if n == 1 or size == full // n:
        return w
    if size != full:
        raise ValueError(f"dim {dim} of size {size} is neither {full} nor "
                         f"its {n}-way block")
    if qt:
        return w.map(lambda a: sharding.block(a, dim, n, i) if a.shape[dim] == full
                     else a)
    return sharding.block(w, dim, n, i)


def ep_quant_einsum_edf(x: torch.Tensor, qw: quant.QuantizedTensor, *,
                        mesh, axis: str | None = None,
                        partition: str = "e", bits_a: int = 8,
                        dp_axis: str | None = None) -> torch.Tensor:
    """Sharded quantized expert einsum "ecd,edf->ecf" on `mesh`.

    partition="e": experts sharded (EP), no reduction.
    partition="d": contraction sharded (TP) with an int32 all_reduce.
    dp_axis: also shard the capacity axis C (DP composition).
    Same logical operands as `bl.serve_einsum_edf`; returns the full
    (E, C, f) output on every rank."""
    E, C, d = x.shape
    ax = _ep_axis(mesh, axis)
    n = mesh.shape[ax]
    i = mesh.index(ax) if n > 1 else 0
    ndp = mesh.shape[dp_axis] if dp_axis is not None else 1
    idp = mesh.index(dp_axis) if ndp > 1 else 0
    if dp_axis is not None and C % ndp:
        raise ValueError(f"C={C} not divisible by {ndp}-way "
                         f"'{dp_axis}' axis")
    dp_group = mesh.group(dp_axis) if dp_axis is not None else None

    if partition == "e":
        if E % n:
            raise ValueError(f"E={E} not divisible by {n}-way '{ax}' axis")
        xb = sharding.block(sharding.block(x, 0, n, i), 1, ndp, idp)
        # local experts only: per-row activation quantization and the
        # int32 accumulator are untouched by the split — structural
        # bit-exactness
        y = bl.serve_einsum_edf(xb, _local(qw, 0, E, n, i),
                                transpose_out=False, bits_a=bits_a)
        y = comm.all_gather(y, dp_group, dim=1)
        return comm.all_gather(y, mesh.group(ax), dim=0)

    if partition == "d":
        wv = qw.unpacked_values()                           # (E, d|d/n, f)
        if d % n:
            raise ValueError(f"d={d} not divisible by {n}-way '{ax}' axis")
        ws = qw.scale.expand(E, 1, wv.shape[-1])
        # quantize with full-row scales BEFORE sharding the contraction, so
        # the partials are raw int32 and the all_reduce is exact
        qx = quant.quantize(x, bits_a, axis=-1)
        xv = sharding.block(sharding.block(qx.values, 2, n, i), 1, ndp, idp)
        acc = bl.edf_accumulate(xv, _local(wv, 1, d, n, i))
        acc = comm.all_reduce(acc, mesh.group(ax), "sum")
        acc = comm.all_gather(acc, dp_group, dim=1)
        return ref.epilogue(acc, qx.scale, ws, x.dtype)

    raise ValueError(f"partition must be 'e' or 'd', got {partition!r}")


# ---------------------------------------------------------------------------
# Full expert-parallel MoE layer
# ---------------------------------------------------------------------------

def _moe_weights(p, E, n=1, i=0):
    """(quantized, [w_gate, w_up, w_down]) — rank i's E/n experts of each
    (`QuantizedTensor`s or float stacks), from whole or placed leaves."""
    quantized = isinstance(p["w_gate"], quant.QuantizedTensor)
    return quantized, [_local(p[name], 0, E, n, i)
                       for name in ("w_gate", "w_up", "w_down")]


def _expert_ffn(buf, weights, quantized, bits_a):
    """gate/up/silu/down on an (E', C', d) buffer — the one expert-compute
    body every dispatch mode and the reference funnel through, so their
    bit-exactness is structural (activation quantization is per row)."""
    gw, uw, dw = weights
    if quantized:
        def mm(xb, w):
            return bl.serve_einsum_edf(xb, w, transpose_out=False,
                                       bits_a=bits_a)
    else:
        def mm(xb, w):
            return torch.einsum("ecd,edf->ecf", xb, w)
    g, u = mm(buf, gw), mm(buf, uw)
    return mm(F.silu(g) * u, dw)


def ep_moe(p, x, cfg, *, mesh, axis: str | None = None,
           capacity_factor: float | None = None, bits_a: int = 8,
           dispatch: str = "global", return_drops: bool = False):
    """Expert-parallel `models.moe.moe`: x (B, S, d) → (out, aux_loss).

    Tokens AND experts are split over the EP axis; `dispatch` selects the
    token movement (module docstring).  Weights may be float or
    serving-quantized; with `return_drops=True` a third output gives the
    (T, k) keep mask (shard-major token order).  `capacity_factor=None`
    resolves to `cfg.moe_capacity_factor`, so a direct call can never
    silently disagree with the dense path."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    ax = _ep_axis(mesh, axis)
    n = mesh.shape[ax]
    if E % n or T % n:
        raise ValueError(f"E={E} and T={T} must divide the {n}-way "
                         f"'{ax}' axis")
    if dispatch not in ("global", "per_source"):
        raise ValueError(f"dispatch must be 'global' or 'per_source', "
                         f"got {dispatch!r}")
    C = moe_capacity(T, E, k, capacity_factor)
    Cs = -(-C // n)                                         # ceil(C / n)
    El, Tl = E // n, T // n
    me = mesh.index(ax) if n > 1 else 0
    group = mesh.group(ax)
    quantized, w = _moe_weights(p, E, n, me)
    xf = comm.copy_to(x, group).reshape(T, d)
    xl = xf[me * Tl:(me + 1) * Tl]
    # every rank routes the whole (replicated) batch and keeps its block:
    # the router's f32 product is then the meshless one bit for bit (a
    # GPU matmul's rounding may depend on its row count)
    router = comm.copy_to(p["router"], group)
    probs, top_p, top_i = (t[me * Tl:(me + 1) * Tl]
                           for t in router_top_k(xf, router, k))
    a = top_i.reshape(Tl * k)
    al = a.long()
    xk = torch.repeat_interleave(xl, k, dim=0)              # (Tl*k, d)

    if dispatch == "global":
        # ---- global capacity dispatch from local routing ----
        counts = _one_hot(a, E, torch.int32).sum(0)
        all_counts = comm.all_gather(counts[None], group, dim=0)  # (n, E)
        src = torch.arange(n, device=x.device)[:, None]
        before = torch.sum(torch.where(src < me, all_counts, 0), dim=0)
        pos = _rank_in_expert_sort(a, E) + before[al]       # global rank
        keep = pos < C
        pos_c = torch.where(keep, pos, C - 1).long()
        buf = dispatch_buffer(E, C, al, pos_c, keep, xk)
        # dispatch: chunk e' of `buf` is this rank's contribution to the
        # experts rank e' owns; the owner sums the sources (dropped tokens
        # were zeroed, so the sum is drop-exact)
        buf = comm.all_to_all(buf.reshape(n, El, C, d), group).sum(0)
        ye = _expert_ffn(buf, w, quantized, bits_a)         # (El, C, d)
        # combine: every source needs every owner's rows (owner order ==
        # axis order, the single-rank buffer layout)
        ye = comm.all_gather_grad(ye, group, dim=0)         # (E, C, d)
        yk = ye[al, pos_c]
    else:
        # ---- per-source capacity dispatch (GShard lossy path) ----
        pos = _rank_in_expert_sort(a, E)                    # local ranks
        keep = pos < Cs
        pos_c = torch.where(keep, pos, Cs - 1).long()
        buf = dispatch_buffer(E, Cs, al, pos_c, keep, xk)
        # int32 sidecar riding the same scatter: (expert id, source-local
        # rank, valid)
        meta = dispatch_buffer(E, Cs, al, pos_c, keep, torch.stack(
            [a.to(torch.int32), pos, torch.ones_like(pos)], dim=-1))
        buf = comm.all_to_all(buf.reshape(n, El, Cs, d), group)
        meta = comm.all_to_all(meta.reshape(n, El, Cs, 3), group)
        # only packed rows contribute (unwritten rows are zero already:
        # kept as the invariant, a bit-exact no-op for the values)
        buf = torch.where(meta[..., 2:3] > 0, buf, 0)       # (n, El, Cs, d)
        buf = buf.permute(1, 0, 2, 3).reshape(El, n * Cs, d)
        ye = _expert_ffn(buf, w, quantized, bits_a)         # (El, n*Cs, d)
        # mirrored combine: owner o's rows for source s go back to s;
        # received chunks are owner-major, which IS the global expert order
        ye = ye.reshape(El, n, Cs, d).permute(1, 0, 2, 3).contiguous()
        ye = comm.all_to_all(ye, group)
        yk = ye.reshape(E, Cs, d)[al, pos_c]

    w_tok = (top_p.reshape(Tl * k).to(x.dtype)
             * keep.to(x.dtype))[:, None]
    out = torch.sum((yk * w_tok).reshape(Tl, k, d), dim=1)

    # ---- Switch load-balance loss (all_reduce'd partial sums) ----
    frac_tokens = comm.all_reduce(
        torch.sum(_one_hot(top_i, E, torch.float32), dim=(0, 1)),
        group) / (T * k)
    frac_probs = comm.reduce_from(torch.sum(probs, dim=0), group) / T
    aux = E * torch.sum(frac_tokens * frac_probs)
    out = comm.gather_from(out, group, 0, me).reshape(B, S, d)
    if return_drops:
        keep = comm.all_gather(keep.reshape(Tl, k), group, dim=0)
        return out, aux, keep
    return out, aux


def per_source_reference(p, x, cfg, *, ep_size: int,
                         capacity_factor: float | None = None,
                         bits_a: int = 8):
    """Single-rank simulator of `ep_moe(dispatch="per_source")`.

    Replays the shard decomposition an `ep_size`-way EP axis would induce —
    tokens in shard-major blocks, shard-local stable-argsort ranks,
    C_src = ceil(C / ep_size) drops — and runs the identical `_expert_ffn`
    body on identically-ordered buffers, so outputs AND the drop mask match
    the distributed path bit for bit.

    Returns (out (B,S,d), aux_loss, keep (T,k) bool in shard-major order).
    """
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    n = ep_size
    if E % n or T % n:
        raise ValueError(f"E={E} and T={T} must divide ep_size={n}")
    C = moe_capacity(T, E, k, capacity_factor)
    Cs = -(-C // n)
    Tl = T // n
    xf = x.reshape(T, d)
    probs, top_p, top_i = router_top_k(xf, p["router"], k)

    # shard-local ranks: each shard-major block of Tl*k assignments is
    # ranked independently — exactly ep_moe's local argsort
    a = top_i.reshape(n, Tl * k)
    pos = torch.stack([_rank_in_expert_sort(a[s], E) for s in range(n)])
    keep = pos < Cs
    pos_c = torch.where(keep, pos, Cs - 1).long()
    xk = torch.repeat_interleave(xf, k, dim=0).reshape(n, Tl * k, d)
    buf = torch.stack([dispatch_buffer(E, Cs, a[s].long(), pos_c[s], keep[s],
                                xk[s]) for s in range(n)])
    # (n, E, Cs, d) → source-major rows per expert, the owners' concat order
    buf = buf.permute(1, 0, 2, 3).reshape(E, n * Cs, d)

    quantized, weights = _moe_weights(p, E)
    ye = _expert_ffn(buf, weights, quantized, bits_a)       # (E, n*Cs, d)

    ybuf = ye.reshape(E, n, Cs, d).permute(1, 0, 2, 3)      # (n, E, Cs, d)
    yk = torch.stack([ybuf[s][a[s].long(), pos_c[s]] for s in range(n)])
    w_tok = (top_p.reshape(n, Tl * k).to(x.dtype)
             * keep.to(x.dtype))[..., None]
    out = torch.sum((yk * w_tok).reshape(n, Tl, k, d), dim=2)

    frac_tokens = torch.mean(_one_hot(top_i, E, torch.float32), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out.reshape(B, S, d), aux, keep.reshape(T, k)
