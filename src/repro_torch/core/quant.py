"""Symmetric low-precision quantization + digit decomposition (BRAMAC §III).

Port of `repro.core.quant`: symmetric per-channel quantization to
n ∈ {2, 4, 8} bits, bit-packing of sub-byte tensors into int8 storage
("main BRAM" layout), and the radix-4 digit decomposition of the hybrid
bit-serial & bit-parallel dataflow:

    x = sum_j 4^j * d_j          for unsigned x
    signed: the top digit is signed, dt ∈ {-2,-1,0,1} = d_top - 4*(d_top>=2).

Arithmetic follows the reference step for step: the scale is computed in
x's dtype and only then cast to f32, and `q = clip(round(x / scale))`
divides before rounding (`torch.round`, like `jnp.round`, rounds half to
even).
"""
from __future__ import annotations

import dataclasses

import torch

SUPPORTED_BITS = (2, 4, 8)


def qrange(bits: int) -> tuple[int, int]:
    """Symmetric signed range for n-bit 2's complement, e.g. 8-bit → [-128, 127]."""
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized tensor: int8 storage (possibly bit-packed) + scale.

    values: int8 tensor; if packed, several sub-byte elements per int8
            along `packed_axis`.
    scale:  f32, broadcastable to the logical (unpacked) shape.
    bits:   2, 4, or 8.
    packed: whether `values` holds bit-packed sub-byte data.
    shape:  logical (unpacked) shape at creation (informational — unpack
            derives shapes from `values`, so period slices stay valid).
    """
    values: torch.Tensor
    scale: torch.Tensor
    bits: int
    packed: bool
    shape: tuple[int, ...]
    packed_axis: int = -1

    def dequantize(self) -> torch.Tensor:
        return self.unpacked_values().to(self.scale.dtype) * self.scale

    def unpacked_values(self) -> torch.Tensor:
        if not self.packed:
            return self.values
        return unpack_axis(self.values, self.bits, self.packed_axis)

    def map(self, fn) -> "QuantizedTensor":
        """The same tensor with `fn` applied to values and scale (device
        moves, period slices)."""
        return dataclasses.replace(self, values=fn(self.values),
                                   scale=fn(self.scale))


@dataclasses.dataclass
class Q8:
    """Block-wise absmax int8 tensor (AdamW's first moment): q (n_blocks,
    BLOCK) int8, scale (n_blocks, 1) f32, and the logical shape."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple[int, ...]


def _check_bits(bits: int) -> None:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"BRAMAC supports bits in {SUPPORTED_BITS}, got {bits}")


def quantize(x: torch.Tensor, bits: int, axis: int | None = -1,
             pack: bool = False, pack_axis: int = -1,
             amax: torch.Tensor | None = None) -> QuantizedTensor:
    """Symmetric quantization of x to n-bit 2's complement.

    axis: channel axis for per-channel scales (None = per-tensor).
    pack: bit-pack sub-byte values along `pack_axis`.
    amax: the absmax to scale by, when the caller reduced it over more
          than `x` (a row-parallel linear's K-slices); default x's own.
    """
    _check_bits(bits)
    lo, hi = qrange(bits)
    if amax is None:
        amax = x.abs().amax() if axis is None \
            else x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / hi          # in x's dtype
    q = torch.clamp(torch.round(x / scale), lo, hi).to(torch.int8)
    if pack and bits < 8:
        return QuantizedTensor(pack_bits_axis(q, bits, pack_axis),
                               scale.to(torch.float32), bits, True,
                               tuple(x.shape), pack_axis)
    return QuantizedTensor(q, scale.to(torch.float32), bits, False,
                           tuple(x.shape))


def requantize(qt: QuantizedTensor, bits: int, axis: int | None = -1,
               pack: bool = False, pack_axis: int = -1) -> QuantizedTensor:
    """Re-quantize an already-quantized tensor to a (usually lower) width:
    dequantize (f32) → quantize, the only faithful route between symmetric
    grids whose scales differ per channel.  Dropping width (8→2) is how a
    serving tree becomes a cheap draft tree."""
    return quantize(qt.dequantize(), bits, axis=axis, pack=pack,
                    pack_axis=pack_axis)


def pack_bits(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack sub-byte signed ints along the last axis into int8 storage
    (4-bit: 2 per byte, 2-bit: 4 per byte; element j of a group sits at
    bit offset j*bits)."""
    _check_bits(bits)
    if bits == 8:
        return q.to(torch.int8)
    per = 8 // bits
    if q.shape[-1] % per:
        raise ValueError(f"last dim {q.shape[-1]} not divisible by {per}")
    u = (q.to(torch.int32) & ((1 << bits) - 1)).to(torch.uint8)
    u = u.reshape(*q.shape[:-1], q.shape[-1] // per, per)
    packed = torch.zeros(u.shape[:-1], dtype=torch.uint8, device=q.device)
    for j in range(per):
        packed = packed | (u[..., j] << (j * bits))
    return packed.view(torch.int8)


def unpack(packed: torch.Tensor, bits: int, shape) -> torch.Tensor:
    """Inverse of pack_bits; returns int8 with sign-extension (§III-C2's mux)."""
    _check_bits(bits)
    if bits == 8:
        return packed.to(torch.int8)
    per = 8 // bits
    u = packed.contiguous().view(torch.uint8)
    mask = (1 << bits) - 1
    parts = [(u >> (j * bits)) & mask for j in range(per)]
    v = torch.stack(parts, dim=-1).reshape(tuple(shape)).to(torch.int32)
    v = torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
    return v.to(torch.int8)


def pack_bits_axis(q: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """pack_bits along an arbitrary axis (movedim → pack → movedim)."""
    if axis in (-1, q.ndim - 1):
        return pack_bits(q, bits)
    moved = torch.movedim(q, axis, -1)
    return torch.movedim(pack_bits(moved, bits), -1, axis).contiguous()


def unpack_axis(packed: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Inverse of pack_bits_axis; logical shape derived from `packed`."""
    per = 8 // bits
    if axis in (-1, packed.ndim - 1):
        shape = tuple(packed.shape[:-1]) + (packed.shape[-1] * per,)
        return unpack(packed, bits, shape)
    moved = torch.movedim(packed, axis, -1)
    shape = tuple(moved.shape[:-1]) + (moved.shape[-1] * per,)
    return torch.movedim(unpack(moved, bits, shape), -1, axis).contiguous()


def num_digits(bits: int) -> int:
    """Radix-4 digit count = ceil(bits/2); BRAMAC pairs two bits per pass."""
    return (bits + 1) // 2


def to_radix4_digits(q: torch.Tensor, bits: int,
                     signed: bool = True) -> torch.Tensor:
    """Decompose n-bit ints into radix-4 digits, least-significant first.

    Returns int8 of shape (num_digits, *q.shape); for signed inputs the
    TOP digit is in {-2..1}, lower digits in {0..3}.
    Invariant: sum_j 4^j * digits[j] == q (exactly, in int32)."""
    _check_bits(bits)
    nd = num_digits(bits)
    u = q.to(torch.int32) & ((1 << bits) - 1)
    digits = []
    for j in range(nd):
        d = (u >> (2 * j)) & 0x3
        if signed and j == nd - 1:
            d = torch.where(d >= 2, d - 4, d)
        digits.append(d.to(torch.int8))
    return torch.stack(digits, dim=0)


def from_radix4_digits(digits: torch.Tensor) -> torch.Tensor:
    """Recompose (for tests): sum_j 4^j * digits[j]."""
    nd = digits.shape[0]
    w = (4 ** torch.arange(nd, dtype=torch.int32, device=digits.device)
         ).reshape((nd,) + (1,) * (digits.ndim - 1))
    return torch.sum(digits.to(torch.int32) * w, dim=0, dtype=torch.int32)


def to_bits(q: torch.Tensor, bits: int, signed: bool = True) -> torch.Tensor:
    """Pure bit-serial decomposition (one bit per plane), LSB first; the
    MSB plane is in {-1, 0} for signed inputs (Algorithm 1's subtraction).
    Invariant: sum_i 2^i * planes[i] == q."""
    _check_bits(bits)
    u = q.to(torch.int32) & ((1 << bits) - 1)
    planes = []
    for i in range(bits):
        b = (u >> i) & 1
        if signed and i == bits - 1:
            b = -b
        planes.append(b.to(torch.int8))
    return torch.stack(planes, dim=0)
