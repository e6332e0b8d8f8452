"""Mamba (selective SSM) mixer: a chunked scan for sequences, an O(1)-state
recurrent step for decode (jamba's sub-quadratic half).

Port of `repro.models.mamba`:

    x → in_proj → (x, z);  x → causal depthwise conv → SiLU
    Δ, B, C selected from x;  h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t;  out = (y ⊙ SiLU(z)) → out_proj

The reference runs `lax.scan` over chunks with a `lax.associative_scan`
inside each; eager PyTorch has no associative scan, so each chunk carries
h step by step (the same combine, h ← dA_t·h + dBx_t, in time order).  That
agrees with the reference's tree order within its own test tolerance.  A
cumprod-and-divide rewrite would not: dA underflows and the division blows
up.  The state is the tuple (h (B, d_in, N) f32, conv_tail (B, K-1, d_in)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, init_dense
from repro_torch.models.xlstm import _chunk_len


def _dt_rank(cfg):
    return cfg.mamba_dt_rank or -(-cfg.d_model // 16)


def init_mamba(gen, cfg, device):
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    N, K, R = cfg.mamba_d_state, cfg.mamba_d_conv, _dt_rank(cfg)
    dt = cfg.compute_dtype
    w_in = init_dense(gen, d, 2 * d_in, dt, device)
    conv_w = (torch.randn((K, d_in), generator=gen, device=device) / K).to(dt)
    # S4D-real initialization for A
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device)).expand(d_in, N).clone()
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        "w_bc": init_dense(gen, d_in, 2 * N, dt, device),
        "w_dt_down": init_dense(gen, d_in, R, dt, device),
        "w_dt_up": init_dense(gen, R, d_in, dt, device),
        # softplus(-4.6) ≈ 1e-2
        "dt_bias": torch.full((d_in,), -4.6, device=device),
        "a_log": a_log,
        "d_skip": torch.ones((d_in,), device=device),
        "w_out": init_dense(gen, d_in, d, dt, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as logaddexp(x, 0) (torch's softplus
    switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p, xc):
    """The common path after the conv: (dA, dBx, C), f32."""
    bc = xc @ p["w_bc"]
    Bm, Cm = torch.chunk(bc.to(torch.float32), 2, dim=-1)    # (..., N)
    dt = softplus((xc @ p["w_dt_down"] @ p["w_dt_up"]).to(torch.float32)
                  + p["dt_bias"])                            # (..., d_in)
    A = -torch.exp(p["a_log"])                               # (d_in, N)
    dA = torch.exp(dt[..., None] * A)                        # (..., d_in, N)
    dBx = (dt * xc.to(torch.float32))[..., None] * Bm[..., None, :]
    return dA, dBx, Cm


def _read_out(h, c):
    """y = C·h per row: (B, d_in, N) x (B, N) -> (B, d_in), as the one
    batched product `einsum("bdn,bn->bd")` lowers to, without its
    permutes and views (a step of the scan issues a third of the ops)."""
    return torch.bmm(h, c[..., None])[..., 0]


def _chunk_scan(h, xc, p):
    """One chunk: h carried through its T steps.  h (B, d_in, N) f32,
    xc (B, T, d_in).  Returns (h_T, y (B, T, d_in) f32)."""
    dA, dBx, Cm = _ssm_inputs(p, xc)            # (B,T,d_in,N) x2, (B,T,N)
    ys = []
    for t in range(xc.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(_read_out(h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + p["d_skip"] * xc.to(torch.float32)
    return h, y


def mamba_sequence(p, x, cfg, h0=None, conv0=None):
    """x: (B, S, d) → (out (B,S,d), (h_final, conv_tail))."""
    B, S, d = x.shape
    d_in = cfg.mamba_expand * d
    K = cfg.mamba_d_conv
    xz = dense(x, p["w_in"], cfg.quant)
    xr, z = torch.chunk(xz, 2, dim=-1)           # (B,S,d_in)

    # causal depthwise conv along S (with optional tail state from decode)
    if conv0 is None:
        conv0 = torch.zeros((B, K - 1, d_in), dtype=xr.dtype, device=x.device)
    xpad = torch.cat([conv0, xr], dim=1)
    xc = sum(xpad[:, i:i + S] * p["conv_w"][i] for i in range(K))
    xc = F.silu(xc + p["conv_b"])
    conv_tail = xpad[:, -(K - 1):] if K > 1 else conv0

    h = h0 if h0 is not None else torch.zeros(
        (B, d_in, cfg.mamba_d_state), device=x.device)
    T = _chunk_len(cfg, S)
    ys = []
    for s in range(0, S, T):
        h, y = _chunk_scan(h, xc[:, s:s + T], p)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    out = dense(y.to(x.dtype) * F.silu(z), p["w_out"], cfg.quant)
    return out, (h, conv_tail)


def mamba_step(p, x, cfg, state):
    """Single-token decode.  x: (B, 1, d); state: (h, conv_tail)."""
    h, conv_tail = state
    xz = dense(x[:, 0], p["w_in"], cfg.quant)
    xr, z = torch.chunk(xz, 2, dim=-1)           # (B, d_in)
    window = torch.cat([conv_tail, xr[:, None]], dim=1)      # (B,K,d_in)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"])
    xc = F.silu(xc + p["conv_b"])
    dA, dBx, Cm = _ssm_inputs(p, xc)             # (B,d_in,N), (B,N)
    h = dA * h + dBx
    y = _read_out(h, Cm) + p["d_skip"] * xc.to(torch.float32)
    out = dense(y.to(x.dtype) * F.silu(z), p["w_out"], cfg.quant)
    return out[:, None], (h, window[:, 1:])


def init_mamba_state(cfg, batch, dtype, device=None):
    d_in = cfg.mamba_expand * cfg.d_model
    return (torch.zeros((batch, d_in, cfg.mamba_d_state), device=device),
            torch.zeros((batch, cfg.mamba_d_conv - 1, d_in), dtype=dtype,
                        device=device))
