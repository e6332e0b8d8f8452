"""Explicit data-parallel trainer with int8 gradient compression + error
feedback over the `data` axis (port of `repro.runtime.dp_trainer`).

Each rank takes its shard of the batch, computes its gradients with
autograd, and (with `compress=True`) runs one per-leaf, block-wise int8
quantization round with the quantization *residual* carried to the next
step (error feedback, which keeps SGD convergence — Karimireddy et al.),
before the `all_reduce` mean that cuts gradient traffic 4x on a
bandwidth-constrained link.  With `compress=False` the gradients are
averaged in full precision.  The params stay replicated on every rank
(the Trainer's own `data` axis is ZeRO-3: `runtime.trainer`).

Where the reference keeps every replica's residual in one array with a
leading (n,) axis sharded over `data`, a rank here holds its own residual
tree (the leading axis is the rank).
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm
from repro_torch.tree import tree_leaves, tree_map

BLOCK = 256


def _q(x):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(fp.abs().amax(1, keepdim=True), min=1e-12) / 127.
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq(q, scale, shape, size):
    return (q.to(torch.float32) * scale).reshape(-1)[:size].reshape(shape)


def compress_decompress(g, err):
    """One error-feedback round: returns (decompressed g_hat, new_err).

    g_hat = DQ(Q(g + err));  new_err = (g + err) - g_hat.
    """
    corrected = g.to(torch.float32) + err
    q, scale = _q(corrected)
    g_hat = _dq(q, scale, g.shape, g.numel())
    return g_hat, corrected - g_hat


def _shard(batch, n: int, i: int):
    """Rank i's block of every batch leaf along axis 0."""
    def take(b):
        if b.shape[0] % n:
            raise ValueError(f"batch of {b.shape[0]} rows does not split "
                             f"{n} ways over the data axis")
        size = b.shape[0] // n
        return b[i * size:(i + 1) * size]
    return tree_map(take, batch)


def mean_over(tree, group, n: int):
    """The `all_reduce` mean of every tensor of `tree` over `group`."""
    return tree_map(lambda t: comm.all_reduce(t, group, "sum") / n, tree)


def make_dp_train_step(loss_fn, mesh, axis: str = "data",
                       compress: bool = True):
    """Build the DP step: per-rank grads → (int8+EF) all_reduce mean.

    loss_fn(params, batch) -> scalar tensor.  params replicated (every
    rank the same tree); batch the global batch, of which each rank takes
    its block along axis 0.  Returns step(params, err_tree, batch) ->
    (grads, new_err_tree, loss), the grads and loss averaged over `axis`
    (identical on every rank)."""
    n = mesh.shape[axis]
    i = mesh.index(axis) if n > 1 else 0
    group = mesh.group(axis)

    def step(params, err, batch):
        local = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss = loss_fn(local, _shard(batch, n, i))
        leaves = tree_leaves(local)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, got)}
        grads = tree_map(lambda p: by_id[id(p)], local)
        if compress:
            pairs = tree_map(lambda g, e: torch.stack(
                compress_decompress(g, e)), grads, err)
            g_hat = tree_map(lambda t: t[0], pairs)
            new_err = tree_map(lambda t: t[1], pairs)
        else:
            g_hat, new_err = grads, err
        return (mean_over(g_hat, group, n), new_err,
                mean_over(loss.detach(), group, n))

    return step


def init_error_feedback(params, mesh, axis: str = "data"):
    """This rank's error buffers (f32 zeros shaped like `params`): each
    replica keeps its own residual, as the reference's (n,)-stacked buffer
    sharded over `axis` keeps one per shard."""
    del mesh, axis
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
