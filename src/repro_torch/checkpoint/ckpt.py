"""Checkpointing: atomic, async-capable, keyed by path (port of
`repro.checkpoint.ckpt`, with the same layout on disk, so a checkpoint
written by either package restores in the other bit for bit).

Layout:  <dir>/step_<N>/
            manifest.json     {"step": N, "leaves": {path: {dtype, shape}}}
            arrays.npz        flat key ("/" written as "|") → ndarray

Paths are `repro_torch.tree`'s: dict keys and tuple indices joined with
"/"; an AdamW `Q8` moment stores its int8 blocks under ".../0" and its
scales under ".../1", as the reference's pytree flattening names them.  bfloat16 leaves (which npz
cannot hold) go in as raw little-endian bytes of shape `shape + (2,)`,
with "bfloat16" as the manifest dtype; no ml_dtypes is needed for that.
`restore(..., device=...)` places every leaf on one torch device, and
`take=` maps each leaf as it is read (a rank's block of a whole leaf).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import SEP, tree_items, tree_map_with_path


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of `t` as (array for npz, manifest dtype)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().view(np.uint8)
        return raw.reshape(tuple(t.shape) + (2,)), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _decode(raw: np.ndarray, dtype_str: str, shape) -> torch.Tensor:
    if dtype_str == "bfloat16":
        flat = torch.from_numpy(np.array(raw, copy=True).reshape(-1))
        return flat.view(torch.bfloat16).reshape(tuple(shape))
    return torch.from_numpy(np.array(raw, copy=True, order="C"))


def save(directory: str, step: int, tree, *, blocking: bool = True):
    """Atomic save of a tree; blocking=False returns the writer thread (the
    host snapshot is taken before this returns, the file write happens in
    the thread — the standard async-checkpoint split)."""
    flat = {k: _encode(v) for k, v in tree_items(tree)}

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace(SEP, "|"): a for k, (a, _) in flat.items()})
        manifest = {k: {"dtype": dt,
                        "shape": list(a.shape[:-1] if dt == "bfloat16"
                                      else a.shape)}
                    for k, (a, dt) in flat.items()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, skeleton, *, device=None,
            take=None):
    """Restore into `skeleton`'s structure and dtypes, every leaf on
    `device` (the skeleton leaf's device if None).  Leaves are read one at
    a time; `take(path, tensor)`, if given, maps each leaf as read (a
    tensor-parallel rank takes its block of the whole leaf)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        names = set(z.files)

        def leaf(key, ref):
            name = key.replace(SEP, "|")
            if name not in names:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _decode(z[name], manifest[key]["dtype"],
                        manifest[key]["shape"])
            if take is not None:
                t = take(key, t)
            return t.to(device=device if device is not None else ref.device,
                        dtype=ref.dtype)

        return tree_map_with_path(leaf, skeleton)


def prune(directory: str, keep: int = 3):
    if not os.path.isdir(directory):
        return
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
