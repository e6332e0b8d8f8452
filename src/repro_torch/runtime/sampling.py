"""On-device token sampling for the serving engine (port of
`repro.runtime.sampling`, the speculative `spec_verify` included).

Each request owns a `torch.Generator` on the engine's device, seeded from
the engine seed and the request seed alone (`request_generator`), never
from the slot: a request's stream is the same whichever slot it lands in,
whatever is batched beside it, and however many decode steps a tick
fuses.  Every emitted token consumes exactly one draw of the request's
generator, in order; greedy consumes none.  The draws are PyTorch's, not
JAX's threefry, so the two packages agree in distribution, not in bits.

Methods:
  greedy      — argmax (first index on ties, as `jnp.argmax`).
  temperature — softmax sample of logits / temperature.
  top_k       — temperature sample restricted to the k highest logits.
  top_p       — temperature sample restricted to the smallest prefix of
                the sorted distribution with cumulative mass >= top_p
                (the best token is always kept).
The stochastic methods sample by Gumbel-max over `_filter_logits`: the
argmax of the filtered logits plus -log(-log(u)) noise, u uniform from the
row's generator.  `spec_verify` accepts or replaces a speculative window:
greedy exactly as the reference (bit for bit), stochastic by rejection
sampling against the draft's point mass, drawing per window from each
request's generator.  Nothing reads a device value back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

METHODS = ("greedy", "temperature", "top_k", "top_p")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"sampling method must be one of {METHODS}, "
                             f"got {self.method!r}")
        if self.temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, "
                             f"got {self.temperature}")
        if self.method == "top_k" and self.top_k < 1:
            raise ValueError(f"top_k sampling needs top_k >= 1, "
                             f"got {self.top_k}")
        if self.method == "top_p" and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def _filter_logits(logits, sc: SamplingConfig):
    """Temperature scaling + top_k / top_p restriction of (B, V) rows; the
    f32 result is what the stochastic methods sample from."""
    l = logits.to(torch.float32) / sc.temperature
    if sc.method == "top_k":
        k = min(sc.top_k, l.shape[-1])
        # rank-based mask: a value threshold (`l >= kth`) would keep EVERY
        # logit tied with the k-th largest.  A stable descending sort ranks
        # ties by lowest index (lax.top_k's rule), so exactly k survive
        idx = torch.sort(l, dim=-1, descending=True, stable=True)[1][:, :k]
        keep = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
        keep.scatter_(1, idx, True)
        l = torch.where(keep, l, float("-inf"))
    elif sc.method == "top_p":
        srt = torch.sort(l, dim=-1, descending=True)[0]
        probs = torch.softmax(srt, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs    # mass strictly above
        keep = before < sc.top_p                        # best always kept
        thresh = torch.where(keep, srt, float("inf")).amin(dim=-1)
        l = torch.where(l >= thresh[:, None], l, float("-inf"))
    return l


def request_generator(base_seed: int, seed: int, device) -> torch.Generator:
    """A request's sampling stream: a generator on `device` seeded from the
    engine seed and the request seed only."""
    mixed = np.random.SeedSequence(
        [int(base_seed) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF]
    ).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(mixed[0]) << 31) ^ int(mixed[1]))
    return g


def _uniforms(gens, shape, device) -> torch.Tensor:
    """(len(gens), *shape) f32 uniforms, one draw of `shape` from each
    row's generator.  A row whose generator is None draws nothing; its
    values are a constant and what it decides means nothing."""
    return torch.stack([
        torch.full(shape, 0.5, device=device) if g is None
        else torch.rand(shape, generator=g, device=device) for g in gens])


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def gumbel_noise(gens, V: int, device) -> torch.Tensor:
    """(len(gens), V) f32 Gumbel noise, one draw of V uniforms from each
    row's generator (None: a constant, no draw)."""
    return _gumbel(_uniforms(gens, (V,), device))


def sample(logits, sc: SamplingConfig, gens=None):
    """logits (B, V) -> tokens (B,) int32.  `gens` lists each row's
    generator (None: the row emits nothing and draws nothing); greedy
    ignores it."""
    if sc.method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = _filter_logits(logits, sc)
    noise = gumbel_noise(gens, l.shape[-1], l.device)
    return torch.argmax(l + noise, dim=-1).to(torch.int32)


def spec_verify(logits, drafts, sc: SamplingConfig, gens=None):
    """Vectorized accept/replace for one speculative draft window.

    logits (B, L, V) scored over the chunk [last_tok, g_1 .. g_d] (L = d+1,
    so logits[:, i] conditions on the first i drafts); drafts (B, d) the
    proposed tokens; `gens` each row's generator (stochastic methods).

    Returns (out (B, L) i32, n_acc (B,) i32): out[:, i] is the token the
    stream emits at window index i if it reaches that far — accepted drafts
    verbatim for i < n_acc, the model's own replacement at i == n_acc (the
    rejection correction for i < d, the bonus token at i == d).  The
    caller clamps how many are emitted (stop tokens / budget / max_seq).

    Greedy: a draft is accepted iff it equals the argmax of the previous
    position's logits, so every emitted token is the token non-speculative
    greedy decoding would produce.  Draws nothing.

    Stochastic: draft g at position i is accepted with probability p_i(g)
    under the filtered distribution (u < p_i(g)); a rejection resamples
    from p_i with g masked out (Gumbel-max over the masked filtered
    logits; the bonus row at i == d masks nothing), so each emitted token
    is marginally ~ p_i.  Each row draws, per window and in this order, L
    acceptance uniforms and then L x V uniforms for the Gumbel noise from
    its own generator; a row whose generator is None draws nothing."""
    B, L, V = logits.shape
    d = L - 1
    if sc.method == "greedy":
        t = torch.argmax(logits, dim=-1).to(torch.int32)           # (B, L)
        ok = (drafts == t[:, :d]).to(torch.int64)
        n_acc = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)
        return t, n_acc
    l = _filter_logits(logits.reshape(B * L, V), sc).reshape(B, L, V)
    probs = torch.softmax(l, dim=-1)
    u = _uniforms(gens, (L,), logits.device)                       # (B, L)
    noise = _gumbel(_uniforms(gens, (L, V), logits.device))        # (B, L, V)
    # a slot with no request may draft the -1 history padding; clamped, its
    # acceptance means nothing (an active slot's drafts are real tokens)
    p_draft = torch.gather(probs[:, :d], 2,
                           drafts.long().clamp(0, V - 1)[..., None])[..., 0]
    acc = (u[:, :d] < p_draft).to(torch.int64)
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)
    # -1 pads the bonus row's draft: it matches no vocabulary id
    pad = torch.cat([drafts.to(torch.int32),
                     torch.full((B, 1), -1, dtype=torch.int32,
                                device=logits.device)], dim=1)     # (B, L)
    vocab = torch.arange(V, device=logits.device)
    lm = torch.where(vocab[None, None, :] == pad[..., None], float("-inf"), l)
    repl = torch.argmax(lm + noise, dim=-1).to(torch.int32)
    idx = torch.arange(L, device=logits.device)[None, :]
    out = torch.where(idx < n_acc[:, None], pad, repl)
    return out, n_acc
