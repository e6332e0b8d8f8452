"""Public entry point for the BRAMAC quantized matmul (port of
`repro.kernels.ops.quant_matmul`).

The tensors' device decides the route: a CUDA tensor launches the
hand-written kernel (`kernels.bramac_matmul`: one int8 tensor-core pass
per radix-4 digit), a CPU tensor takes its plain digit-pass version.  No
padding to blocks is needed: the CUDA kernel zero-fills the ragged edges
of its tiles itself.  The QAT `bramac_dense` (straight-through gradients)
belongs to the training slice.
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
