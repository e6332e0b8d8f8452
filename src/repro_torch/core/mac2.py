"""Algorithm 1 — Hybrid Bit-Serial & Bit-Parallel MAC2, in PyTorch.

Port of `repro.core.mac2`:

    P = W1*I1 + W2*I2   (all 2's complement n-bit, n ∈ {2, 4, 8})

The paper's dataflow (BRAMAC §III-B, Fig 3/4):

  * A 7-row "dummy array" holds rows
        [0] zero     [1] W1      [2] W2      [3] W1+W2
        [4] Inverter [5] P       [6] Accumulator
  * For input bit i from MSB down to LSB, the bit-pair {I2[i], I1[i]}
    selects one of rows 0..3 as `psum` (a 4-entry LUT — this is what makes
    the dataflow *bit-parallel* across the whole 160-bit row).
  * If i is the MSB: P += ~psum + 1 (2's complement subtraction, using the
    Inverter row), else P += psum.  If i != LSB: P <<= 1.
  * After the LSB pass, P holds the MAC2 result; row 6 accumulates multiple
    MAC2s of a long dot product in place.

`mac2` runs the loop step by step on int32 lanes (wrapping as the
reference's int32 arithmetic does), on the device of its tensors.
`mac2_mvm` issues every column pair of a matrix at once as lanes and then
sums over the pairs: integer sums give the same result in any order.  It is
the plain version of the dummy-array CUDA kernel (`kernels.mac2_kernel`).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import SUPPORTED_BITS

__all__ = ["mac2", "mac2_reference", "mac2_mvm", "lane_width"]


def lane_width(bits: int) -> int:
    """Sign-extended lane width per element (§III-C2): 8/16/32 for 2/4/8-bit.

    A n-bit MAC2 needs at most 2n+1 bits; the sign-extension mux provides
    8/16/32-bit lanes so sequential MAC2s can be accumulated in-place (row 6).
    """
    return {2: 8, 4: 16, 8: 32}[bits]


def _int32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def mac2(w1, w2, i1, i2, bits: int, signed_inputs: bool = True) -> torch.Tensor:
    """Faithful Algorithm 1. w1/w2: int tensors (lanes), i1/i2: ints or
    tensors broadcastable against lanes. Returns int32 P = w1*i1 + w2*i2.

    The loop runs over input bits MSB→LSB; each iteration does the 4-way row
    select and one bit-parallel add, matching the eFSM schedule.
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}")
    dev = w1.device if isinstance(w1, torch.Tensor) else None
    w1 = _int32(w1, dev)               # sign-extension mux: lanes widened
    w2 = _int32(w2, dev)
    i1 = _int32(i1, dev)
    i2 = _int32(i2, dev)
    # dummy-array rows 0..3: the LUT  {0, W1, W2, W1+W2}
    zero = torch.zeros_like(w1)
    lut = torch.stack([zero, w1, w2, w1 + w2], dim=0)

    u1 = i1 & ((1 << bits) - 1)        # unsigned bit views of the inputs
    u2 = i2 & ((1 << bits) - 1)

    shape = torch.broadcast_shapes(w1.shape, i1.shape)
    lut_b = lut.reshape((4,) + (1,) * (len(shape) - w1.ndim) + w1.shape) \
        .expand((4,) + shape)
    p = torch.zeros(shape, dtype=torch.int32, device=w1.device)
    for i in range(bits - 1, -1, -1):
        b1 = (u1 >> i) & 1
        b2 = (u2 >> i) & 1
        sel = b2 * 2 + b1              # {I2[i], I1[i]} → demux select
        # 2-to-4 demux row select, per lane (row read of the dummy array)
        sel_b = sel.to(torch.int64).expand(shape)[None]
        psum = torch.take_along_dim(lut_b, sel_b, dim=0)[0]
        if i == bits - 1 and signed_inputs:
            # MSB: P += inv(psum) + 1   (row 4, the Inverter, then +1 carry-in)
            p = p + ((~psum) + 1)
        else:
            p = p + psum
        if i != 0:
            p = p << 1                 # shift left unless LSB
    return p


def mac2_reference(w1, w2, i1, i2) -> torch.Tensor:
    """Direct integer oracle."""
    dev = w1.device if isinstance(w1, torch.Tensor) else None
    return _int32(w1, dev) * _int32(i1, dev) + _int32(w2, dev) * _int32(i2, dev)


def mac2_mvm(w: torch.Tensor, x: torch.Tensor, bits: int,
             signed_inputs: bool = True) -> torch.Tensor:
    """Matrix-vector multiply via chained MAC2s (paper Fig 2).

    w: (rows, cols) int weights; x: (cols,) int inputs; cols must be even.
    Column pairs (2k, 2k+1) are issued as MAC2s sharing the input pair
    (x[2k], x[2k+1]); their results accumulate as the Accumulator row does.
    Returns int32 (rows,) = w @ x.
    """
    rows, cols = w.shape
    if cols % 2:
        raise ValueError("mac2_mvm needs an even number of columns (MAC2 pairs)")
    wp = w.to(torch.int32).reshape(rows, cols // 2, 2)
    xp = x.to(device=w.device, dtype=torch.int32).reshape(cols // 2, 2)
    p = mac2(wp[:, :, 0], wp[:, :, 1], xp[:, 0], xp[:, 1], bits=bits,
             signed_inputs=signed_inputs)
    # int64 sum, then the low 32 bits: the int32 accumulator's wrap
    return p.sum(dim=1, dtype=torch.int64).to(torch.int32)
