"""Shared neural layers: norms, dense (BRAMAC-aware), SwiGLU MLP, RoPE, embed.

Port of `repro.models.layers`: `init_*` returns a parameter dict, the
apply functions consume it.  Every matmul flows through `dense()`, so the
BRAMAC quantized path is one switch across the model.

Under an active sharding ctx whose `tp` axis splits the model (the mesh
Engine, the tensor-parallel Trainer), the Megatron split that the
reference's `_PARAM_RULES` name is written out here: column-parallel
linears (`wq`/`wk`/`wv`/`w_gate`/`w_up`) run on their local columns, their
block's input passed once through `column_input` (identity forward, the
gradient summed over the axis in backward), the row-parallel ones (`wo`,
`w_down`) go through `dense_row`, and `unembed` gathers its vocab columns
(in backward each rank keeps its own columns' gradient).  The MLA, mamba
and xLSTM mixers take their own collectives over `tp_line()`; where a
mixer computes something whole on every rank (through weights kept
whole) and each rank then reads only its own block of it, the
`copy_to` stands at that boundary (`column_inputs`), so that the whole
computation's weights get their whole gradient on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bramac_linear as bl
from repro_torch.core.quant import QuantizedTensor
from repro_torch.parallel import comm, sharding, tp


def dense(x: torch.Tensor, w, quant: bl.QuantConfig | None) -> torch.Tensor:
    """All model matmuls route here → BRAMAC integration point."""
    return bl.dense(x, w, quant)


def column_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel block: `x` itself, or under a
    tp-splitting ctx `comm.copy_to` over the tp axis, so that the
    backward sums the ranks' partial input gradients."""
    ax = sharding.tp_axis()
    if ax is None:
        return x
    return comm.copy_to(x, sharding.active().mesh.group(ax))


def column_inputs(*ts: torch.Tensor) -> tuple:
    """`column_input` of several tensors of one dtype and leading shape,
    the point where a computation every rank runs whole hands its results
    to the rank's own columns or heads: one gradient sum over the axis in
    backward for all of them (packed along the last dim).  The tensors
    themselves where nothing needs a gradient (serving)."""
    ax = sharding.tp_axis()
    if ax is None or not any(t.requires_grad for t in ts):
        return ts
    packed = comm.copy_to(torch.cat(ts, -1),
                          sharding.active().mesh.group(ax))
    return packed.split([t.shape[-1] for t in ts], -1)


def tp_line():
    """(group, n, i) of the active ctx's tp axis line — its process group,
    its size and this rank's index on it — or None when no ctx splits the
    model: what a mixer with its own collectives reads."""
    ax = sharding.tp_axis()
    if ax is None:
        return None
    mesh = sharding.active().mesh
    return mesh.group(ax), mesh.shape[ax], mesh.index(ax)


def dense_row(x: torch.Tensor, w, quant: bl.QuantConfig | None
              ) -> torch.Tensor:
    """A row-parallel linear (`wo`, `w_down`): `dense`, or under a
    tp-splitting ctx `tp.row_parallel_dense` on this rank's input slice
    and weight rows (one max and one sum collective)."""
    ax = sharding.tp_axis()
    if ax is None:
        return dense(x, w, quant)
    return tp.row_parallel_dense(x, w, quant, mesh=sharding.active().mesh,
                                 axis=ax)


# ---------------------------------------------------------------------------
# init helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def he_init(gen: torch.Generator, shape, dtype, device, fan_in=None):
    """normal(shape) / sqrt(fan_in), drawn in f32 and cast (as the
    reference's `he_init`)."""
    fan_in = fan_in or shape[0]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    x.div_(torch.sqrt(torch.full((), float(fan_in), device=device)))
    return x.to(dtype)


def init_dense(gen, d_in, d_out, dtype, device):
    return he_init(gen, (d_in, d_out), dtype, device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, dtype, device):
    return {"w_gate": init_dense(gen, d_model, d_ff, dtype, device),
            "w_up": init_dense(gen, d_model, d_ff, dtype, device),
            "w_down": init_dense(gen, d_ff, d_model, dtype, device)}


def mlp(p, x, quant=None):
    x = column_input(x)
    g = dense(x, p["w_gate"], quant)
    u = dense(x, p["w_up"], quant)
    return dense_row(F.silu(g) * u, p["w_down"], quant)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                                  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab, d_model, dtype, device):
    emb = torch.randn((vocab, d_model), generator=gen, device=device,
                      dtype=torch.float32) * 0.02
    return {"embedding": emb.to(dtype),
            "unembed": init_dense(gen, d_model, vocab, dtype, device)}


def embed(p, tokens):
    return p["embedding"][tokens.long()]


def unembed(p, x, quant=None):
    """Logits over the whole vocab: under a tp-splitting ctx the unembed
    holds this rank's vocab columns (the embedding stays whole), and the
    logits are all-gathered along the vocab."""
    w = p["unembed"]
    cols = (w.values if isinstance(w, QuantizedTensor) else w).shape[-1]
    ax = sharding.tp_axis()
    if ax is None or cols == p["embedding"].shape[0]:
        return dense(x, w, quant)
    mesh = sharding.active().mesh
    logits = dense(column_input(x), w, quant)
    return comm.gather_from(logits, mesh.group(ax), -1, mesh.index(ax))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
