"""Plain PyTorch versions of the BRAMAC matmul (port of `repro.kernels.ref`).

`quant_matmul_exact` is the ground truth (exact integer matmul + dequant).
`quant_matmul_digit_ref` mirrors the radix-4 digit dataflow of the kernel
step by step; it is the plain version `kernels.bramac_matmul` runs for CPU
tensors and holds its CUDA kernel against on the card.

Integer dots run as float64 matmuls: every product and partial sum here is
an integer far below 2^53, so the result is exact in any summation order
(CUDA has no integer matmul, and this keeps one code path for both
devices).  The epilogue multiplies in the kernel's order,
`(acc_f32 * x_scale) * w_scale`, then casts to `out_dtype`.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import num_digits


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (..., M, K) @ (..., K, N) → int64, via float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def epilogue(acc, x_scale, w_scale, out_dtype):
    """The one dequant epilogue: (acc_f32 * x_scale) * w_scale, cast."""
    return (acc.to(torch.float32) * x_scale.to(torch.float32)
            * w_scale.to(torch.float32)).to(out_dtype)


def quant_matmul_exact(x_q, w_q, x_scale, w_scale,
                       out_dtype=torch.float32) -> torch.Tensor:
    """(M,K) int ⋅ (K,N) int → dequantized (M,N)."""
    return epilogue(int_dot(x_q, w_q), x_scale, w_scale, out_dtype)


def quant_matmul_digit_ref(x_q, w_q, x_scale, w_scale, bits_a: int,
                           signed: bool = True,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Radix-4 digit-pass matmul (BRAMAC hybrid dataflow): one bit-parallel
    integer matmul per base-4 activation digit, shift-accumulated; the top
    digit of signed inputs carries negative weight (Algorithm 1 line 5)."""
    nd = num_digits(bits_a)
    u = x_q.to(torch.int32) & ((1 << bits_a) - 1)
    acc = torch.zeros((x_q.shape[0], w_q.shape[1]), dtype=torch.int64,
                      device=x_q.device)
    for j in range(nd):
        d = (u >> (2 * j)) & 0x3
        if signed and j == nd - 1:
            d = torch.where(d >= 2, d - 4, d)
        acc = acc + int_dot(d, w_q) * (4 ** j)
    return epilogue(acc.to(torch.int32), x_scale, w_scale, out_dtype)


def mac2_mvm_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the dummy-array MVM kernel: exact w @ x (int32)."""
    return int_dot(w, x[:, None])[:, 0].to(torch.int32)
