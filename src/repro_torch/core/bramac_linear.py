"""BRAMAC quantized linear — the paper's technique as a composable module.

Port of `repro.core.bramac_linear`, in its two execution styles:

  * **training / QAT**: a float weight under an enabled config runs the
    fake-quant forward through the BRAMAC integer dataflow with
    straight-through gradients (`ops.bramac_dense`).
  * **serving**: weights are quantized **once** offline (`prepare_serving`)
    into int8/packed storage — the "main BRAM" resident layout — and every
    call quantizes activations on the fly and runs the integer kernel
    (`serve_dense`, and per expert `serve_einsum_edf`).

`QuantConfig.bits ∈ {2,4,8}` selects the MAC precision exactly as BRAMAC's
`prec` instruction field does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bramac_matmul import bramac_matmul, \
    bramac_matmul_plain


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """BRAMAC precision config (the CIM instruction's static fields)."""
    enabled: bool = False
    bits_w: int = 8          # weight precision (2/4/8)
    bits_a: int = 8          # activation precision (2/4/8)
    use_kernel: bool = False  # kept so configs compare equal to the
    #                           reference's; in the port the tensors' device
    #                           picks the route (kernels/ops.py)

    def __post_init__(self):
        if self.bits_w not in quant.SUPPORTED_BITS or \
           self.bits_a not in quant.SUPPORTED_BITS:
            raise ValueError("BRAMAC supports 2/4/8-bit only")


FP32 = QuantConfig(enabled=False)


def dense(x: torch.Tensor, w, cfg: QuantConfig | None) -> torch.Tensor:
    """Linear y = x @ w through the configured path: a float weight runs a
    plain matmul (fp) or the QAT fake-quant (`ops.bramac_dense`, enabled
    config); a pre-quantized `QuantizedTensor` runs the serving path."""
    if isinstance(w, quant.QuantizedTensor):
        return serve_dense(x, w, cfg)
    if cfg is None or not cfg.enabled:
        return x @ w
    return ops.bramac_dense(x, w, cfg.bits_w, cfg.bits_a)


def prepare_serving(w: torch.Tensor, cfg: QuantConfig) -> quant.QuantizedTensor:
    """Quantize a weight once for inference: per-output-channel scales over
    the contraction axis (−2); 4/2-bit values bit-packed along it.  Stacked
    (periods, …, in, out) weights are quantized one period at a time, which
    gives the same result as one call and keeps temporaries small."""
    if w.ndim > 2:
        return _stack([prepare_serving(w[i], cfg) for i in range(w.shape[0])],
                      tuple(w.shape))
    return quant.quantize(w, cfg.bits_w, axis=w.ndim - 2,
                          pack=cfg.bits_w < 8, pack_axis=-2)


def _stack(parts, shape) -> quant.QuantizedTensor:
    """Per-period QuantizedTensors stacked back along a leading axis."""
    return quant.QuantizedTensor(
        torch.stack([p.values for p in parts]),
        torch.stack([p.scale for p in parts]), parts[0].bits,
        parts[0].packed, shape, parts[0].packed_axis)


def serve_dense(x: torch.Tensor, qw: quant.QuantizedTensor,
                cfg: QuantConfig | None) -> torch.Tensor:
    """Inference-time linear with pre-quantized device-resident weights."""
    bits_a = cfg.bits_a if (cfg and cfg.enabled) else min(qw.bits, 8)
    x2 = x.reshape(-1, x.shape[-1])
    qx = quant.quantize(x2, bits_a, axis=-1)
    w_vals = qw.unpacked_values()
    y = ops.quant_matmul(qx.values, w_vals, qx.scale, qw.scale.reshape(1, -1),
                         bits_a=bits_a, bits_w=qw.bits, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def edf_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Unit-scale int32 mode of the expert einsum "ecd,edf->ecf": the exact
    integer product of int8 (E, C, d) and (E, d, f) operands, int32 out, no
    dequant (the reference's batched int8 `dot_general`).  Every product and
    partial sum is an integer far below 2^53, so `ref.int_dot`'s float64
    matmul is exact where f32 is not (2048 x 127 x 127 > 2^24)."""
    return ref.int_dot(x_q, w_q).to(torch.int32)


def _einsum_edf(x, qw, bits_a, matmul):
    """Quantize the (E, C, a) buffer per row once, then one `matmul` call per
    expert into its rows of one (E, C, b) output.  4-bit weights go as
    stored, pair-packed along the contraction axis; 2-bit ones unpacked."""
    qx = quant.quantize(x, bits_a, axis=-1)                 # per (e, c) row
    packed = qw.packed and qw.bits == 4
    w = qw.values if packed else qw.unpacked_values()
    out = torch.empty(tuple(x.shape[:2]) + (w.shape[-1],), dtype=x.dtype,
                      device=x.device)
    for e in range(x.shape[0]):
        matmul(qx.values[e], w[e], qx.scale[e], qw.scale[e], bits_a=bits_a,
               bits_w=qw.bits, out_dtype=x.dtype, w_packed=packed,
               out=out[e])
    return out


def serve_einsum_edf(x: torch.Tensor, qw: quant.QuantizedTensor,
                     transpose_out: bool, bits_a: int = 8) -> torch.Tensor:
    """Quantized expert einsum: "ecd,edf->ecf" (transpose_out=False) or
    "ecf,efd->ecd" (True, the same contraction layout), one `bramac_matmul`
    per expert.  The kernel's epilogue `(acc * x_scale) * w_scale` is the
    reference's `acc * qx.scale * qw.scale`, so the result is bit-exact to
    it.  All E experts run on every call, empty ones too: skipping them
    would need the counts on the host."""
    return _einsum_edf(x, qw, bits_a, bramac_matmul)


def serve_einsum_edf_plain(x: torch.Tensor, qw: quant.QuantizedTensor,
                           transpose_out: bool,
                           bits_a: int = 8) -> torch.Tensor:
    """`serve_einsum_edf` through `bramac_matmul_plain` on any device: what
    the kernel route is held against on the card."""
    return _einsum_edf(x, qw, bits_a, bramac_matmul_plain)


# Matmul weights consumed through dense() (quantizable at serving time);
# the embedding (a gather) and the norms are excluded by design.
_SERVABLE = frozenset(
    "wq wk wv wo w_gate w_up w_down unembed w_dq w_uq w_dkv w_uk w_uv "
    "w_kr w_in w_out w_gates".split())


def tree_prepare_serving(params: Any, cfg: QuantConfig,
                         predicate=None) -> Any:
    """Quantize matmul weights (incl. stacked per-period tensors) in a
    nested-dict parameter tree for serving; other leaves pass through."""
    def default_pred(path: str, leaf) -> bool:
        return leaf.ndim >= 2 and path.split(".")[-1] in _SERVABLE

    pred = predicate or default_pred

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}.{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, torch.Tensor) and pred(path, node):
            return prepare_serving(node, cfg)
        return node

    return visit(params, "")


def requantize_serving(qw: quant.QuantizedTensor,
                       cfg: QuantConfig) -> quant.QuantizedTensor:
    """A serving weight re-quantized to `cfg.bits_w` with `prepare_serving`'s
    layout (per-output-channel scales over the contraction axis, sub-byte
    values packed along it).  Stacked (periods, in, out) weights go one
    period at a time, as in `prepare_serving`: the same values and scales
    as one call over the stack, with one period's f32 temporary."""
    if qw.values.ndim > 2:
        parts = [requantize_serving(qw.map(lambda a, i=i: a[i]), cfg)
                 for i in range(qw.values.shape[0])]
        return _stack(parts, (qw.values.shape[0],) + parts[0].shape)
    return quant.requantize(qw, cfg.bits_w, axis=0, pack=cfg.bits_w < 8,
                            pack_axis=-2)


def tree_requantize_serving(params: Any, cfg: QuantConfig,
                            predicate=None) -> Any:
    """Re-quantize a parameter tree to `cfg.bits_w` for serving.

    Like `tree_prepare_serving`, but also takes trees whose servable leaves
    are ALREADY `QuantizedTensor`s (a serving tree demoted to a low-bit
    draft tree): those round-trip through `quant.requantize`, float
    servable leaves quantize directly, everything else (embedding, norms)
    passes through untouched."""
    def default_pred(path: str, leaf) -> bool:
        if isinstance(leaf, quant.QuantizedTensor):
            return True
        return leaf.ndim >= 2 and path.split(".")[-1] in _SERVABLE

    pred = predicate or default_pred

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, f"{path}.{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, quant.QuantizedTensor) and pred(path, node):
            return requantize_serving(node, cfg)
        if isinstance(node, torch.Tensor) and pred(path, node):
            return prepare_serving(node, cfg)
        return node

    return visit(params, "")
