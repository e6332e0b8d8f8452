"""Token sampling for the serving engine (port of `repro.runtime.sampling`).

Greedy sampling is an on-device argmax (first index on ties, as
`jnp.argmax`).  The stochastic methods need per-request `torch.Generator`
streams and come with a later slice; `sample` raises for them, and so does
the Engine at construction.  `_filter_logits` (temperature, top-k with the
rank-based tie rule, top-p) is ported already: it is pure tensor code.
"""
from __future__ import annotations

import dataclasses

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


def sample(logits, sc: SamplingConfig):
    """logits (B, V) -> tokens (B,) int32."""
    if sc.method != "greedy":
        raise NotImplementedError(
            f"{sc.method!r} sampling needs per-request torch.Generator "
            "streams (stochastic sampling), which are not ported yet")
    return torch.argmax(logits, dim=-1).to(torch.int32)
