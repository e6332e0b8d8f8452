"""Carry a parameter tree from the JAX package into the port.

The caller hands over the JAX tree as nested dicts of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)`), so this module needs no
JAX.  bf16 leaves (ml_dtypes' numpy bfloat16) cross bit for bit through a
uint16 view; a JAX `QuantizedTensor` (recognised by its fields) crosses
field by field into the port's own `QuantizedTensor`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor

_QT_FIELDS = ("values", "scale", "bits", "packed", "shape", "packed_axis")


def array_to_torch(a, device=None) -> torch.Tensor:
    """numpy array (bf16 included) → torch tensor with identical bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device) if device is not None else t


def from_jax_tree(tree, device=None):
    """Nested dicts of numpy arrays / JAX QuantizedTensors → the port's
    tree on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QuantizedTensor(array_to_torch(tree.values, device),
                               array_to_torch(tree.scale, device),
                               int(tree.bits), bool(tree.packed),
                               tuple(int(s) for s in tree.shape),
                               int(tree.packed_axis))
    if isinstance(tree, (np.ndarray, np.generic)):
        return array_to_torch(tree, device)
    raise TypeError(f"cannot convert leaf of type {type(tree).__name__}")
