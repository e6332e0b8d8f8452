"""BRAMAC radix-4 digit-pass quantized matmul: CUDA kernel wrapper.

Replaces the Pallas TPU kernel `repro/kernels/bramac_matmul.py::_kernel`
(its `pl.pallas_call` at bramac_matmul.py:126).  The kernel source is
`csrc/bramac_matmul.cu`: one int8 tensor-core MMA (`mma.sync` s8) per
radix-4 digit pass, weights streamed through a `cp.async` ring in shared
memory, one weight read per 16 (decode) or 64 rows; its header note gives
the H100 bounds (weight bytes at decode, the int8 crossover at M=64) and
what the design does about them.  `_plan` picks the block rows and the
split of K that fill the card.

`bramac_matmul` launches the kernel for CUDA tensors and runs the plain
PyTorch version (`bramac_matmul_plain`, the radix-4 digit reference) for
CPU tensors — the device of the tensors decides, nothing else.  There is
no fallback: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import build, ref

_OUT_DTYPES = (torch.float32, torch.bfloat16)
BN, BK = 128, 128         # the kernel's block columns and K step (bytes)


def _plan(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """Launch plan -> (bm, splits, k_per_split).

    bm, the block's rows, is 16 for M <= 16 (decode) and 64 above.  K is
    split into `splits` ranges of k_per_split (a whole number of BK steps;
    the last range may be shorter) so that about two waves of blocks cover
    the `sms` SMs, as far as K has steps to split."""
    bm = 16 if M <= 16 else 64
    tiles = -(-N // BN) * -(-M // bm)
    steps = max(1, -(-K // BK))
    want = max(1, min(-(-2 * sms // tiles), steps))
    per = -(-steps // want)
    return bm, -(-steps // per), per * BK


def bramac_matmul_plain(x_q, w_q, x_scale, w_scale, *, bits_a: int,
                        bits_w: int, signed: bool = True,
                        out_dtype=torch.float32,
                        w_packed: bool = False) -> torch.Tensor:
    """The plain version: unpack pair-packed weights along K, then the
    digit-pass reference (`ref.quant_matmul_digit_ref`)."""
    if w_packed:
        w_q = quant.unpack_axis(w_q, bits_w, 0)
    return ref.quant_matmul_digit_ref(x_q, w_q, x_scale, w_scale, bits_a=bits_a,
                                      signed=signed, out_dtype=out_dtype)


def _check(x_q, w_q, x_scale, w_scale, bits_a, bits_w, out_dtype, w_packed):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"bramac_matmul takes int8 operands, got "
                        f"{x_q.dtype} x {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError("bramac_matmul takes 2-D (M,K) x (K,N) operands")
    if bits_a not in quant.SUPPORTED_BITS or bits_w not in quant.SUPPORTED_BITS:
        raise ValueError(f"bits must be in {quant.SUPPORTED_BITS}")
    if w_packed and bits_w != 4:
        raise ValueError("packed storage implemented for 4-bit weights")
    M, K = x_q.shape
    k_rows = K // 2 if w_packed else K
    if w_packed and K % 2:
        raise ValueError(f"packed weights need an even K, got {K}")
    if w_q.shape[0] != k_rows:
        raise ValueError(f"weight rows {w_q.shape[0]} do not match K={K}"
                         f"{' (packed)' if w_packed else ''}")
    N = w_q.shape[1]
    if tuple(x_scale.shape) not in ((M, 1), (1, 1)):
        raise ValueError(f"x_scale must be (M,1) or (1,1), got "
                         f"{tuple(x_scale.shape)}")
    if tuple(w_scale.shape) not in ((1, N), (1, 1)):
        raise ValueError(f"w_scale must be (1,N) or (1,1), got "
                         f"{tuple(w_scale.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    return M, K, N


def bramac_matmul(x_q, w_q, x_scale, w_scale, *, bits_a: int, bits_w: int,
                  signed: bool = True, out_dtype=torch.float32,
                  w_packed: bool = False) -> torch.Tensor:
    """Quantized matmul (M,K)·(K,N) → (M,N) via the BRAMAC dataflow.

    x_q:     (M, K) int8 holding bits_a-bit values.
    w_q:     (K, N) int8, or (K//2, N) pair-packed int8 when w_packed
             (byte r: low nibble W[2r], high nibble W[2r+1]).
    x_scale: (M, 1) or (1, 1) f32 per-row activation scales.
    w_scale: (1, N) or (1, 1) f32 per-column weight scales.
    """
    M, K, N = _check(x_q, w_q, x_scale, w_scale, bits_a, bits_w, out_dtype,
                     w_packed)
    tensors = (x_q, w_q, x_scale, w_scale)
    if all(t.device.type == "cpu" for t in tensors):
        return bramac_matmul_plain(x_q, w_q, x_scale, w_scale, bits_a=bits_a,
                                   bits_w=bits_w, signed=signed,
                                   out_dtype=out_dtype, w_packed=w_packed)
    dev = x_q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("bramac_matmul operands must all be on one CUDA "
                         "device (or all on the CPU)")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    xs = x_scale.to(torch.float32).expand(M, 1).reshape(M).contiguous()
    ws = w_scale.to(torch.float32).expand(1, N).reshape(N).contiguous()
    acc = torch.empty((M, N), dtype=torch.int32, device=dev)
    bm, _, k_per_split = _plan(
        M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = build.library("bramac_matmul")
    err = lib.bramac_matmul_launch(
        x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        acc.data_ptr(), out.data_ptr(), M, K, N, bits_a, int(signed),
        int(w_packed), int(out_dtype == torch.bfloat16), bm, k_per_split,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "bramac_matmul")
    bramac_matmul.launches += 1
    return out


bramac_matmul.launches = 0
