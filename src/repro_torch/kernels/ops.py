"""Public entry point for the BRAMAC quantized matmul (port of
`repro.kernels.ops.quant_matmul`).

The tensors' device decides the route: a CUDA tensor launches the
hand-written kernel (`kernels.bramac_matmul`: one int8 tensor-core pass
per radix-4 digit), a CPU tensor takes its plain digit-pass version.  No
padding to blocks is needed: the CUDA kernel zero-fills the ragged edges
of its tiles itself.  `bramac_dense` is the training-friendly fake-quant
(QAT) dense with a straight-through-estimator backward.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels.bramac_matmul import bramac_matmul


def quant_matmul(x_q, w_q, x_scale, w_scale, *, bits_a: int, bits_w: int,
                 signed: bool = True, out_dtype=torch.float32,
                 w_packed: bool = False):
    """Quantized (M,K)x(K,N) matmul through the BRAMAC kernel.

    w_q is the unpacked (K, N) weight; with w_packed=True it is pair-packed
    along K here (low nibble of byte r = W[2r], high nibble = W[2r+1]) and
    the kernel consumes the packed storage."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32,
                              device=x_q.device).reshape(-1, 1)
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32,
                              device=x_q.device).reshape(1, -1)
    if w_packed:
        w_q = quant.pack_bits(w_q.T, bits_w).T.contiguous()
    return bramac_matmul(x_q, w_q, x_scale, w_scale, bits_a=bits_a,
                         bits_w=bits_w, signed=signed, out_dtype=out_dtype,
                         w_packed=w_packed)


# ---------------------------------------------------------------------------
# Training-facing fake-quant dense with straight-through estimator.
# ---------------------------------------------------------------------------

class _BramacDense(torch.autograd.Function):
    """Forward: per-row `quantize(x, bits_a)`, per-column `quantize(w,
    bits_w)`, then `quant_matmul` (the kernel for CUDA tensors).  Backward
    treats quantization as identity: dx = g @ w^T, dw = x^T @ g, cast as
    the reference's `_bramac_dense_bwd` casts them."""

    @staticmethod
    def forward(ctx, x, w, bits_w, bits_a):
        x2 = x.reshape(-1, x.shape[-1])
        qx = quant.quantize(x2, bits_a, axis=-1)           # per-row
        qw = quant.quantize(w, bits_w, axis=0)             # per-column
        y = quant_matmul(qx.values, qw.values, qx.scale, qw.scale,
                         bits_a=bits_a, bits_w=bits_w, out_dtype=x.dtype)
        ctx.save_for_backward(x, w)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        dx = (g2 @ w.T).reshape(x.shape).to(x.dtype)
        dw = (x2.T @ g2).to(w.dtype)
        return dx, dw, None, None


def bramac_dense(x: torch.Tensor, w: torch.Tensor, bits_w: int,
                 bits_a: int) -> torch.Tensor:
    """y = dequant(Q(x) · Q(w)) with STE gradients (port of
    `repro.kernels.ops.bramac_dense`): the forward runs the integer BRAMAC
    dataflow (per-row activation scales, per-column weight scales)."""
    return _BramacDense.apply(x, w, bits_w, bits_a)
