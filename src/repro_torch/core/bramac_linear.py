"""BRAMAC quantized linear — the paper's technique as a composable module.

Port of the serving half of `repro.core.bramac_linear`: weights are
quantized **once** offline (`prepare_serving`) into int8/packed storage —
the "main BRAM" resident layout — and every call quantizes activations on
the fly and runs the integer kernel (`serve_dense`).  The QAT path
(`ops.bramac_dense`, straight-through gradients) belongs to the training
slice of the port, which is not written yet.

`QuantConfig.bits ∈ {2,4,8}` selects the MAC precision exactly as BRAMAC's
`prec` instruction field does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops


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
    plain matmul; a pre-quantized `QuantizedTensor` runs the serving path."""
    if isinstance(w, quant.QuantizedTensor):
        return serve_dense(x, w, cfg)
    if cfg is None or not cfg.enabled:
        return x @ w
    raise NotImplementedError(
        "quantized training (bramac_dense with straight-through gradients) "
        "is not ported yet; quantize the weights "
        "for serving with tree_prepare_serving")


def prepare_serving(w: torch.Tensor, cfg: QuantConfig) -> quant.QuantizedTensor:
    """Quantize a weight once for inference: per-output-channel scales over
    the contraction axis (−2); 4/2-bit values bit-packed along it.  Stacked
    (periods, …, in, out) weights are quantized one period at a time, which
    gives the same result as one call and keeps temporaries small."""
    if w.ndim > 2:
        parts = [prepare_serving(w[i], cfg) for i in range(w.shape[0])]
        return quant.QuantizedTensor(
            torch.stack([p.values for p in parts]),
            torch.stack([p.scale for p in parts]), parts[0].bits,
            parts[0].packed, tuple(w.shape), parts[0].packed_axis)
    return quant.quantize(w, cfg.bits_w, axis=w.ndim - 2,
                          pack=cfg.bits_w < 8, pack_axis=-2)


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
