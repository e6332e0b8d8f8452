"""Shared neural layers: norms, dense (BRAMAC-aware), SwiGLU MLP, RoPE, embed.

Port of `repro.models.layers`: `init_*` returns a parameter dict, the
apply functions consume it.  Every matmul flows through `dense()`, so the
BRAMAC quantized path is one switch across the model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bramac_linear as bl


def dense(x: torch.Tensor, w, quant: bl.QuantConfig | None) -> torch.Tensor:
    """All model matmuls route here → BRAMAC integration point."""
    return bl.dense(x, w, quant)


# ---------------------------------------------------------------------------
# init helpers (random weights from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def he_init(gen: torch.Generator, shape, dtype, device, fan_in=None):
    """normal(shape) / sqrt(fan_in), drawn in f32 and cast (as the
    reference's `he_init`)."""
    fan_in = fan_in or shape[0]
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    denom = torch.sqrt(torch.full((), float(fan_in), device=device))
    return (x / denom).to(dtype)


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
    g = dense(x, p["w_gate"], quant)
    u = dense(x, p["w_up"], quant)
    return dense(F.silu(g) * u, p["w_down"], quant)


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
    return dense(x, p["unembed"], quant)
