"""BRAMAC dummy-array MVM through chained MAC2s: CUDA kernel wrapper.

Replaces the Pallas TPU kernel `repro/kernels/mac2_kernel.py::_kernel`
(its `pl.pallas_call` at mac2_kernel.py:88), the faithful emulator of the
7-row dummy array.  The kernel source is `csrc/mac2_kernel.cu`; its header
note gives the H100 bound and what the design does about it.

The kernel runs Algorithm 1 as one int8 tensor-core MMA whose 8 columns
are the bit passes; `_plan` picks the block rows and the split of C that
fill the card.

`mac2_mvm_kernel` launches the kernel for CUDA tensors and runs the plain
PyTorch version (`mac2_mvm_kernel_plain`, Algorithm 1 in `core.mac2`) for
CPU tensors — the device of the tensors decides, nothing else.  There is no
fallback: a CUDA tensor the kernel does not take raises.  The reference's
`block`/`interpret` arguments and its `R % block` rule are TPU tiling and
have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.core import mac2, quant
from repro_torch.kernels import build

WIN, CHUNK = 64, 16384      # the kernel's K window and x chunk (bytes)
MAX_SPLITS = 8              # blocks of a cluster: the portable size
BLOCK_ROWS = (64, 32, 16)   # the block heights it takes


def _plan(R: int, C: int, sms: int) -> tuple[int, int, int]:
    """Launch plan -> (rows per block, splits, k_per_split).

    A block takes `rows` rows (one 16-row MMA tile a warp) over a K range
    of k_per_split columns, a whole number of WIN-byte windows.  The splits
    of one row block form a thread block cluster, so there are at most
    MAX_SPLITS of them.  The plan takes the fewest splits that launch two
    blocks per SM with 64- or 32-row blocks, as far as C has windows, and
    else 16-row blocks with all the splits C allows (fewer, longer ranges
    measured fastest on the H100).  The kernel's MMAs sum at most CHUNK
    columns (|S_i| <= 128 * CHUNK, far below 2^31) before it folds them
    into the uint32 result, so no K range is too long."""
    wins = max(1, -(-C // WIN))
    plan = BLOCK_ROWS[-1], min(MAX_SPLITS, wins)
    for splits in range(1, min(MAX_SPLITS, wins) + 1):
        rows = next((r for r in BLOCK_ROWS[:2]
                     if -(-R // r) * splits >= 2 * sms), None)
        if rows:
            plan = rows, splits
            break
    rows, splits = plan
    per = -(-wins // splits)
    return rows, -(-wins // per), per * WIN


def mac2_mvm_kernel_plain(w: torch.Tensor, x: torch.Tensor, *, bits: int,
                          signed: bool = True) -> torch.Tensor:
    """The plain version: Algorithm 1 over every column pair (`core.mac2`)."""
    return mac2.mac2_mvm(w, x, bits, signed_inputs=signed)


def _check(w, x, bits):
    if w.dtype != torch.int8 or x.dtype != torch.int8:
        raise TypeError(f"mac2_mvm_kernel takes int8 operands, got "
                        f"{w.dtype} and {x.dtype}")
    if w.ndim != 2 or x.ndim != 1:
        raise ValueError("mac2_mvm_kernel takes w (R, C) and x (C,)")
    R, C = w.shape
    if C % 2:
        raise ValueError("columns must pair up for MAC2")
    if x.shape[0] != C:
        raise ValueError(f"x has {x.shape[0]} elements for {C} columns")
    if bits not in quant.SUPPORTED_BITS:
        raise ValueError(f"bits must be in {quant.SUPPORTED_BITS}")
    return R, C


def mac2_mvm_kernel(w: torch.Tensor, x: torch.Tensor, *, bits: int,
                    signed: bool = True) -> torch.Tensor:
    """MVM w @ x through chained MAC2s on the dummy array.

    w: (R, C) int8 (bits-bit values); x: (C,) int8, each read as its
    `bits`-bit view (two's complement when `signed`).  C must be even.
    Returns (R,) int32.
    """
    R, C = _check(w, x, bits)
    if w.device.type == "cpu" and x.device.type == "cpu":
        return mac2_mvm_kernel_plain(w, x, bits=bits, signed=signed)
    if w.is_meta or x.is_meta:
        raise ValueError("mac2_mvm_kernel has no meta route (the dry run "
                         "counts the serving and training paths only)")
    dev = w.device
    if dev.type != "cuda" or x.device != dev:
        raise ValueError("mac2_mvm_kernel operands must both be on one CUDA "
                         "device (or both on the CPU)")
    out = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0 or C == 0:
        return out.zero_()
    w, x = w.contiguous(), x.contiguous()
    rows, _, kps = _plan(
        R, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = build.library("mac2_kernel")
    err = lib.mac2_mvm_launch(w.data_ptr(), x.data_ptr(), out.data_ptr(), R,
                              C, bits, int(signed), rows, kps,
                              torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mac2_mvm_kernel")
    mac2_mvm_kernel.launches += 1
    return out


mac2_mvm_kernel.launches = 0
