"""Carry a parameter or AdamW state tree from the JAX package into the
port.

The caller hands over the JAX tree as nested dicts and tuples of numpy
arrays (`jax.tree_util.tree_map(np.asarray, tree)`), so this module
needs no JAX.  bf16 leaves (ml_dtypes' numpy bfloat16) cross bit for bit
through a uint16 view; a JAX `QuantizedTensor` and an AdamW `Q8` moment
(each recognised by its fields) cross field by field into the port's own
types, and the optimizer's `step` as an int32 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import Q8, QuantizedTensor
from repro_torch.tree import tree_map

_QT_FIELDS = ("values", "scale", "bits", "packed", "shape", "packed_axis")
_Q8_FIELDS = ("q", "scale", "shape")


def array_to_torch(a, device=None) -> torch.Tensor:
    """numpy array (bf16 included) → torch tensor with identical bits."""
    a = np.array(a, copy=True, order="C")      # keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def from_jax_tree(tree, device=None):
    """Nested dicts and tuples of numpy arrays / JAX QuantizedTensors / Q8
    moments → the port's tree on `device` (a recurrent state crosses as its
    tuple)."""
    return tree_map(lambda a: _leaf(a, device), tree, leaf_type=object)


def _leaf(a, device):
    if all(hasattr(a, f) for f in _QT_FIELDS):
        return QuantizedTensor(array_to_torch(a.values, device),
                               array_to_torch(a.scale, device),
                               int(a.bits), bool(a.packed),
                               tuple(int(s) for s in a.shape),
                               int(a.packed_axis))
    if all(hasattr(a, f) for f in _Q8_FIELDS):
        return Q8(array_to_torch(a.q, device),
                  array_to_torch(a.scale, device),
                  tuple(int(s) for s in a.shape))
    if isinstance(a, (np.ndarray, np.generic)):
        return array_to_torch(a, device)
    raise TypeError(f"cannot convert leaf of type {type(a).__name__}")
