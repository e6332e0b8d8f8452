"""xLSTM mixers: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, inherently sequential) — arXiv:2405.04517.

Port of `repro.models.xlstm`.  mLSTM cell (per head, stabilized
exponential gating):
    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) k_t v_tᵀ
    n_t = (same recurrence on k_t)
    h_t = (q_t C_t) / max(|q_t·n_t|, exp(-m_t))

A sequence runs the chunkwise-parallel form (intra-chunk quadratic
attention + an inter-chunk (C, n, m) carry) in a Python loop over chunks;
`mlstm_recurrent_ref` is the step-by-step oracle the tests hold it to.
Decode is the O(1)-state recurrent step.  States are tuples, as in the
reference: mLSTM (C, n, m), sLSTM (h, c, n, m), all f32; m starts at
-1e30.  Mixed-dtype products promote as JAX's do (bf16 x f32 runs in f32),
so a bf16 model keeps the reference's roundings.

Under a tp-splitting mesh (the mesh Engine) `cfg` is the rank's
`RankConfig`.  mLSTM: `w_up` splits in its two parts
(`sharding._GROUPED`), so the rank holds its block of xm and of z; it
gathers xm over the axis (one collective) and runs `wq`/`wk`/`wv`
column-parallel on the whole xm, which gives its H/n heads; `w_if` and
`b_if` stay whole, and it keeps its heads' gates.  The cell runs on the
local heads.  The norm is over the whole projection width, so it gathers h
(one collective), normalizes, and keeps its block; `w_down` is
row-parallel (`layers.dense_row`: a max and a sum).  Four collectives a
layer.  sLSTM: the recurrence needs the whole h at every step, so the cell
(`w_gates`, `r_gates`, `b_gates` and the state) stays whole on every rank
(`sharding.serve_whole`), where the reference's rules split `w_gates`
and `r_gates` by columns.  Its FF keeps `w_up` whole too and computes
gelu(a)·b over the whole width, laid out as the meshless block lays it
out, then keeps the rank's block of it for the row-parallel `w_down`: an
activation on a narrower row can round differently on the CPU, where
ATen runs the lanes past the last full vector pair through a scalar tanh
(one ulp apart at a 48-lane row).  Two collectives a layer.  Every rank's
result equals the meshless one bit for bit where the linears are
quantized (the row-parallel sum is exact in int32).

Training (the tensor-parallel Trainer) runs the same forwards.  mLSTM:
both gathers are `comm.all_gather_grad` (each rank's backward reaches
the whole xm and the whole h through its own heads only, so the ranks'
partial gradients are summed and each keeps its block: a reduce-scatter
each); for the same reason the whole `w_if`, `b_if` and `norm` get a
partial gradient on each rank, summed over the axis once a step
(`runtime.trainer.model_partial`).  sLSTM: the cell and the FF's
gelu(a)·b run whole on every rank, and the product passes
`layers.column_input` right before the rank keeps its block for
`w_down`, so `w_up`, `norm` and the cell get their whole gradient on
every rank (one gradient sum a layer).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (column_input, dense, dense_row,
                                       init_dense, init_rmsnorm, rmsnorm,
                                       tp_line)
from repro_torch.parallel import comm


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of two operands promoted to their common dtype (jnp.einsum's
    promotion; torch.einsum wants one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg, device):
    d = cfg.d_model
    dp = cfg.mlstm_width
    H = cfg.num_heads
    dt = cfg.compute_dtype
    return {
        "w_up": init_dense(gen, d, 2 * dp, dt, device),
        "wq": init_dense(gen, dp, dp, dt, device),
        "wk": init_dense(gen, dp, dp, dt, device),
        "wv": init_dense(gen, dp, dp, dt, device),
        "w_if": init_dense(gen, dp, 2 * H, torch.float32, device),
        "b_if": torch.cat([torch.zeros((H,), device=device),
                           torch.full((H,), 3.0, device=device)]),
        "norm": init_rmsnorm(dp, dt, device),
        "w_down": init_dense(gen, dp, d, dt, device),
    }


def _mlstm_gates(p, xm, heads):
    """(logi, logf) of the `heads` (a slice) from the whole xm: w_if is
    whole, its columns [i gates of every head | f gates of every head]."""
    H = p["w_if"].shape[-1] // 2
    gf = xm.to(torch.float32) @ p["w_if"] + p["b_if"]
    return gf[..., :H][..., heads], \
        F.logsigmoid(gf[..., H:])[..., heads]               # (..., H) each


def _qkv(p, xm, cfg, H):
    B, T, _ = xm.shape
    dh = cfg.mlstm_width // H
    q = dense(xm, p["wq"], cfg.quant).reshape(B, T, H, dh)
    k = dense(xm, p["wk"], cfg.quant).reshape(B, T, H, dh) / (dh ** 0.5)
    v = dense(xm, p["wv"], cfg.quant).reshape(B, T, H, dh)
    return q, k, v


def _mlstm_in(p, x, cfg, line):
    """(xm the whole row, z this rank's block, this rank's heads) after the
    up projection; xm gathered under tensor parallelism."""
    up = dense(column_input(x), p["w_up"], cfg.quant)
    xm, z = torch.chunk(up, 2, dim=-1)
    H = cfg.num_heads
    if line is None:
        return xm, z, slice(0, H)
    group, _, i = line
    return comm.all_gather_grad(xm, group, -1), z, slice(i * H, (i + 1) * H)


def _mlstm_out(p, h, z, cfg, line):
    """norm over the whole projection width (h gathered under tensor
    parallelism, this rank's block kept) → ·silu(z) → w_down."""
    if line is None:
        normed = rmsnorm(p["norm"], h, cfg.norm_eps)
    else:
        group, _, i = line
        w = h.shape[-1]
        normed = rmsnorm(p["norm"], comm.all_gather_grad(h, group, -1),
                         cfg.norm_eps)[..., i * w:(i + 1) * w]
    return dense_row(normed * F.silu(z), p["w_down"], cfg.quant)


def _mlstm_chunk(carry, q, k, v, logi, logf):
    """One chunk of the chunkwise-parallel mLSTM (all heads batched).

    carry: C (B,H,dk,dv), n (B,H,dk), m (B,H)
    q, k, v (B,T,H,dh); logi / logf (B,T,H).  Returns (carry, h (B,T,H,dh))."""
    C, n, m = carry
    T = q.shape[1]
    lam = torch.cumsum(logf, dim=1)                       # Λ_t inclusive
    lam_T = lam[:, -1]                                    # (B,H)

    # per-token output stabilizer: max(Λ_t+m, max_{s≤t}(Λ_t−Λ_s+logi_s))
    a = logi - lam                                        # logi_s − Λ_s
    intra_max = torch.cummax(a, dim=1).values
    m_out = torch.maximum(lam + m[:, None], lam + intra_max)   # (B,T,H)

    # intra-chunk quadratic term: w[t,s] = exp(Λ_t−Λ_s+logi_s−m_out_t), s≤t
    scores = _ein("bthd,bshd->bhts", q, k)                # (B,H,T,T)
    lam_h = lam.transpose(1, 2)                           # (B,H,T)
    logw = (lam_h[:, :, :, None] - lam_h[:, :, None, :]
            + logi.transpose(1, 2)[:, :, None, :])        # (B,H,T,S)
    m_out_h = m_out.transpose(1, 2)                       # (B,H,T)
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    w = torch.where(tri, torch.exp(logw - m_out_h[..., None]),
                    torch.zeros((), dtype=logw.dtype, device=q.device))
    ws = w * scores
    h_intra = _ein("bhts,bshd->bthd", ws, v)
    n_intra = torch.sum(ws, dim=-1).transpose(1, 2)       # (B,T,H)

    # contribution from the carried state
    w_prev = torch.exp(lam + m[:, None] - m_out)          # (B,T,H)
    h_prev = _ein("bthd,bhde->bthe", q, C) * w_prev[..., None]
    n_prev = _ein("bthd,bhd->bth", q, n) * w_prev

    denom = torch.maximum(torch.abs(n_intra + n_prev), torch.exp(-m_out))
    h = (h_intra + h_prev) / denom[..., None]

    # state update (fold the whole chunk into (C, n, m))
    m_new = torch.maximum(lam_T + m, lam_T + torch.amax(a, dim=1))
    decay = torch.exp(lam_T + m - m_new)                  # (B,H)
    wk = torch.exp(lam_T[:, None] - lam + logi - m_new[:, None])   # (B,T,H)
    C_new = decay[..., None, None] * C + _ein("bthd,bthe->bhde",
                                              k * wk[..., None], v)
    n_new = decay[..., None] * n + _ein("bth,bthd->bhd", wk, k)
    return (C_new, n_new, m_new), h


def _chunk_len(cfg, S: int) -> int:
    """The reference's chunk length: chunk_size, or the whole sequence
    when chunk_size does not divide it."""
    T = min(cfg.chunk_size, S)
    return S if S % T else T


def mlstm_sequence(p, x, cfg, state=None):
    """x: (B,S,d) → (out, state).  state: (C, n, m) per head."""
    B, S, d = x.shape
    H = cfg.num_heads
    line = tp_line()
    xm, z, heads = _mlstm_in(p, x, cfg, line)
    q, k, v = _qkv(p, xm, cfg, H)
    logi, logf = _mlstm_gates(p, xm, heads)
    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    T = _chunk_len(cfg, S)
    hs = []
    for s in range(0, S, T):
        state, h = _mlstm_chunk(state, *(a[:, s:s + T]
                                         for a in (q, k, v, logi, logf)))
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, cfg.mlstm_width).to(x.dtype)
    return _mlstm_out(p, h, z, cfg, line), state


def mlstm_step(p, x, cfg, state):
    """Single-token decode; O(1) state update.  x: (B, 1, d)."""
    C, n, m = state
    B = x.shape[0]
    H = cfg.num_heads
    line = tp_line()
    xm, z, heads = _mlstm_in(p, x[:, 0], cfg, line)
    q, k, v = _qkv(p, xm[:, None], cfg, H)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                   # (B,H,dh)
    logi, logf = _mlstm_gates(p, xm[:, None], heads)
    logi, logf = logi[:, 0], logf[:, 0]                   # (B,H)

    m_new = torch.maximum(logf + m, logi)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(logi - m_new)
    C = f_s[..., None, None] * C + i_s[..., None, None] * \
        _ein("bhd,bhe->bhde", k, v)
    n = f_s[..., None] * n + i_s[..., None] * k
    num = _ein("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(_ein("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, cfg.mlstm_width).to(x.dtype)
    return _mlstm_out(p, h, z, cfg, line)[:, None], (C, n, m_new)


def init_mlstm_state(cfg, batch, device=None):
    H = cfg.num_heads
    dh = cfg.mlstm_width // H
    return (torch.zeros((batch, H, dh, dh), device=device),
            torch.zeros((batch, H, dh), device=device),
            torch.full((batch, H), -1e30, device=device))


def mlstm_recurrent_ref(p, x, cfg):
    """Step-by-step oracle (tests only)."""
    B, S, _ = x.shape
    state = init_mlstm_state(cfg, B, x.device)
    outs = []
    for t in range(S):
        o, state = mlstm_step(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, device):
    d = cfg.d_model
    dp = cfg.slstm_width
    dt = cfg.compute_dtype
    return {
        "w_gates": init_dense(gen, d, 4 * d, dt, device),    # z, i, f, o
        "r_gates": init_dense(gen, d, 4 * d, dt, device),    # recurrent
        "b_gates": torch.zeros((4 * d,), device=device),
        "norm": init_rmsnorm(d, dt, device),
        "w_up": init_dense(gen, d, 2 * dp, dt, device),
        "w_down": init_dense(gen, dp, d, dt, device),
    }


def _slstm_cell(p, wx_t, hcnm):
    """wx_t: the input projection W·x_t, computed for the whole sequence
    before the loop; only the recurrent R·h_{t-1} is sequential, in f32."""
    h, c, n, m = hcnm                                     # (B,d) f32 each
    g = (wx_t.to(torch.float32)
         + h.to(torch.float32) @ p["r_gates"].to(torch.float32)
         + p["b_gates"])
    z, gi, gf, go = torch.chunk(g, 4, dim=-1)
    z = torch.tanh(z)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i_s = torch.exp(gi - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    h_new = torch.sigmoid(go) * (c / torch.clamp(n, min=1e-6))
    return (h_new, c, n, m_new)


def _slstm_out(p, h, cfg):
    """norm → up projection → gelu(a) · b → down projection.  jax.nn.gelu
    defaults to the tanh approximation."""
    h = rmsnorm(p["norm"], h, cfg.norm_eps)
    a, b = torch.chunk(dense(h, p["w_up"], cfg.quant), 2, dim=-1)
    ab = F.gelu(a, approximate="tanh") * b
    line = tp_line()
    if line is not None:                 # this rank's block of w_down's K
        _, n, i = line
        w = ab.shape[-1] // n
        ab = column_input(ab)[..., i * w:(i + 1) * w]
    return dense_row(ab, p["w_down"], cfg.quant)


def slstm_sequence(p, x, cfg, state=None):
    B, S, d = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    wx = dense(x, p["w_gates"], cfg.quant)        # hoisted input projection
    hs = []
    for t in range(S):
        state = _slstm_cell(p, wx[:, t], state)
        hs.append(state[0])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_out(p, h, cfg), state


def slstm_step(p, x, cfg, state):
    wx = dense(x[:, 0], p["w_gates"], cfg.quant)
    state = _slstm_cell(p, wx, state)
    return _slstm_out(p, state[0][:, None].to(x.dtype), cfg), state


def init_slstm_state(cfg, batch, device=None):
    d = cfg.d_model
    z = torch.zeros((batch, d), device=device)
    return (z, z.clone(), z.clone(),
            torch.full((batch, d), -1e30, device=device))
