"""Tensor-parallel quantized matmul — explicit collectives over the `model`
axis (port of `repro.parallel.tp`: §VI's many-tile scale-out, across
ranks instead of BRAMs).

Two partitionings of `quant_matmul`, both bit-exact against the
single-rank kernel:

  * **K-sharded (row-parallel)** — each rank holds a (M, K/n) activation
    slice and the matching (K/n, N) weight rows, runs the BRAMAC kernel
    with *unit scales* in its int32 output mode (`bramac_matmul(...,
    out_dtype=torch.int32)`), and an integer `all_reduce` sum joins the
    partials before a single dequant epilogue — the dummy-array
    Accumulator row across ranks.
  * **N-sharded (column-parallel)** — each rank owns full-K columns of the
    weight (and their per-column scales); no reduction, and an
    `all_gather` of the columns assembles the output.

Exactness caveat (the kernel's f32 epilogue): the int32 mode converts the
f32 value of the accumulator, which is exact up to 2^24; per-rank partials
are smaller than the single-rank accumulator, so any (bits, K) that is
exact on one rank is exact sharded.

`row_parallel_dense` is the model's row-parallel linear (`wo`, `w_down`):
the activation row's scale comes from the global absmax (`all_reduce`
max), the local K-slice is quantized with it, and the k path above runs —
bit-exact against the meshless `serve_dense` wherever the partials stay
below 2^24.

The physical axis defaults to the active `tp` rule (`sharding`), else
"model".  Callers of `tp_quant_matmul` pass the full logical operands, as
the reference's do; each rank takes its block.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.parallel import comm, sharding


def _tp_axis(mesh, axis: str | None) -> str:
    """Resolve the physical TP axis: explicit arg > active `tp` rule >
    "model"."""
    if axis is not None:
        return axis
    ctx = sharding.active()
    if ctx is not None:
        phys = ctx.rules.get("tp")
        if isinstance(phys, str):
            return phys
    return "model"


def row_parallel_acc(xq, wq, *, bits_a, bits_w, signed, group):
    """This rank's (M, K/n) x (K/n, N) partial through the kernel's int32
    unit-scale mode, summed over `group`: the exact int32 accumulator."""
    one = torch.ones((1, 1), dtype=torch.float32, device=xq.device)
    acc = ops.quant_matmul(xq, wq, one, one, bits_a=bits_a, bits_w=bits_w,
                           signed=signed, out_dtype=torch.int32)
    return comm.all_reduce(acc, group, "sum")


def tp_quant_matmul(x_q, w_q, x_scale, w_scale, *, mesh, bits_a: int,
                    bits_w: int, axis: str | None = None,
                    partition: str = "k", signed: bool = True,
                    out_dtype=torch.float32):
    """Tensor-parallel (M,K)x(K,N) quantized matmul on `mesh`.

    partition="k": row-parallel with an int32 partial-sum all_reduce.
    partition="n": column-parallel, the output all_gathered.
    Inputs are the same full logical operands as `ops.quant_matmul`."""
    M, K = x_q.shape
    N = w_q.shape[-1]
    ax = _tp_axis(mesh, axis)
    n = mesh.shape[ax]
    xs = torch.as_tensor(x_scale, dtype=torch.float32,
                         device=x_q.device).expand(M, 1)
    ws = torch.as_tensor(w_scale, dtype=torch.float32,
                         device=x_q.device).expand(1, N)
    group = mesh.group(ax)
    if partition == "k":
        if K % n:
            raise ValueError(f"K={K} not divisible by {n}-way '{ax}' axis")
        i = mesh.index(ax)
        acc = row_parallel_acc(sharding.block(x_q, 1, n, i).contiguous(),
                               sharding.block(w_q, 0, n, i).contiguous(),
                               bits_a=bits_a, bits_w=bits_w, signed=signed,
                               group=group)
        return ref.epilogue(acc, xs, ws, out_dtype)
    if partition == "n":
        if N % n:
            raise ValueError(f"N={N} not divisible by {n}-way '{ax}' axis")
        i = mesh.index(ax)
        y = ops.quant_matmul(x_q, sharding.block(w_q, 1, n, i).contiguous(),
                             xs.contiguous(),
                             sharding.block(ws, 1, n, i).contiguous(),
                             bits_a=bits_a, bits_w=bits_w, signed=signed,
                             out_dtype=out_dtype)
        return comm.all_gather(y, group, dim=1)
    raise ValueError(f"partition must be 'k' or 'n', got {partition!r}")


def _rows_quantized(x2, wq, ws, bits_a, bits_w, group, out_dtype):
    """The row-parallel product of this rank's (M, K/n) float rows `x2`
    and integer weight rows `wq` (column scales `ws`): the rows quantized
    at the global per-row absmax (one `all_reduce` max), the int32
    partials summed (one `all_reduce` sum), one epilogue."""
    if wq.shape[0] != x2.shape[1]:
        raise ValueError(f"row-parallel weight has {wq.shape[0]} rows for a "
                         f"{x2.shape[1]}-feature input slice (K/n must "
                         f"split the stored rows)")
    x_amax = comm.all_reduce(x2.abs().amax(dim=-1, keepdim=True), group,
                             "max")
    qx = quant.quantize(x2, bits_a, axis=-1, amax=x_amax)
    acc = row_parallel_acc(qx.values, wq, bits_a=bits_a, bits_w=bits_w,
                           signed=True, group=group)
    return ref.epilogue(acc, qx.scale, ws.to(torch.float32), out_dtype)


class _RowParallelQAT(torch.autograd.Function):
    """The QAT row-parallel linear.  Forward: the weight's column scales
    from the global absmax (one `all_reduce` max), then `_rows_quantized`.
    Backward: `ops._BramacDense`'s straight-through products on this
    rank's rows, cast as it casts them; the output gradient is replicated,
    so no collective: dx_local = g @ w_local^T, dw_local = x_local^T @ g."""

    @staticmethod
    def forward(ctx, x2, w, bits_a, bits_w, group):
        w_amax = comm.all_reduce(w.abs().amax(dim=0, keepdim=True), group,
                                 "max")
        qw = quant.quantize(w, bits_w, axis=0, amax=w_amax)
        ctx.save_for_backward(x2, w)
        return _rows_quantized(x2, qw.values, qw.scale, bits_a, bits_w,
                               group, x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g2 = g.to(w.dtype)
        return (g2 @ w.T).to(x2.dtype), (x2.T @ g2).to(w.dtype), None, \
            None, None


def row_parallel_dense(x: torch.Tensor, w, qcfg, *, mesh,
                       axis: str) -> torch.Tensor:
    """The row-parallel linear of a `axis`-split model: `x` (..., K/n) is
    this rank's slice of the input features, `w` the matching rows of the
    weight (a serving `QuantizedTensor`, or a float weight).  Returns the
    full (..., N) output on every rank of the axis line.

    Quantized: the row scale is the reference's per-row absmax over the
    whole K (an `all_reduce` max of the slices' absmax), so every rank
    quantizes its slice to the meshless integers; one row-parallel int32
    reduction, one epilogue.  A float weight under an enabled QuantConfig
    (the QAT forward) takes its column scales the same way and trains
    through `_RowParallelQAT`; a float weight without one sums its float
    partials through `comm.reduce_from`.  Both carry gradients."""
    group = mesh.group(axis)
    x2 = x.reshape(-1, x.shape[-1])
    enabled = qcfg is not None and qcfg.enabled
    if isinstance(w, quant.QuantizedTensor):
        bits_a = qcfg.bits_a if enabled else min(w.bits, 8)
        y = _rows_quantized(x2, w.unpacked_values(), w.scale.reshape(1, -1),
                            bits_a, w.bits, group, x.dtype)
    elif enabled:
        y = _RowParallelQAT.apply(x2, w, qcfg.bits_a, qcfg.bits_w, group)
    else:
        y = comm.reduce_from(x2 @ w, group)
    return y.reshape(*x.shape[:-1], y.shape[-1])
