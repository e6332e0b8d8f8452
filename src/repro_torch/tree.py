"""Trees of dicts and tuples over tensors: the port's parameters, caches
and optimizer state.

A `QuantizedTensor` and an AdamW `Q8` moment are leaves of their own:
`tree_leaves` returns them whole, while `tree_map`, `tree_map_with_path`
and `tree_items` reach the tensors inside them.  Paths are named as the
reference's pytree flattening names them: dict keys and tuple indices
joined by "/", a Q8's int8 blocks and scales under ".../0" and ".../1", a
QuantizedTensor's under ".../values" and ".../scale".
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import Q8, QuantizedTensor

SEP = "/"

# (path name, field) of the tensors inside each leaf container
_PARTS = {Q8: (("0", "q"), ("1", "scale")),
          QuantizedTensor: (("values", "values"), ("scale", "scale"))}


def tree_map(fn, tree, *rest, leaf_type=torch.Tensor):
    """Map `fn` over the leaves of type `leaf_type` of a tree of dicts and
    tuples (a QuantizedTensor or Q8 maps the tensors inside it).  `rest`
    are trees of the same structure whose corresponding leaves (tensors or
    flags) are passed after each leaf; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), leaf_type=leaf_type)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest),
                              leaf_type=leaf_type)
                     for i, v in enumerate(tree))
    parts = _PARTS.get(type(tree))
    if parts:
        return dataclasses.replace(tree, **{f: fn(getattr(tree, f))
                                            for _, f in parts})
    if isinstance(tree, leaf_type):
        return fn(tree, *rest)
    return tree


def tree_map_with_path(fn, tree, path: str = ""):
    """`fn(path, tensor)` over every tensor of `tree`, those inside a
    QuantizedTensor or Q8 included, dict entries in key order (as
    `tree_leaves` and the reference order them); the results in the same
    structure."""
    def sub(k):
        return f"{path}{SEP}{k}" if path else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], sub(k)) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(tree_map_with_path(fn, v, sub(i))
                     for i, v in enumerate(tree))
    parts = _PARTS.get(type(tree))
    if parts:
        return dataclasses.replace(tree, **{f: fn(sub(name), getattr(tree, f))
                                            for name, f in parts})
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def tree_items(tree) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of `tree`, in `tree_leaves` order."""
    out = []
    tree_map_with_path(lambda k, t: out.append((k, t)), tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and tuples: dict entries in key
    order, tuple entries in place; a QuantizedTensor or Q8 is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
