"""Deterministic synthetic token pipeline — stateless, restart and
straggler friendly (port of `repro.data.pipeline`).

Every batch is a pure function of (seed, step), so a restart after a
failure resumes with zero drift, nothing of the loader needs
checkpointing, and skipping ahead is O(1).  The stream embeds an order-1
Markov structure so the training loss actually decreases.  The numpy
batches are the reference's bit for bit; `batch(step, device)` puts them
on a torch device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random Markov transition with low entropy → learnable
        k = min(cfg.vocab_size, 512)
        self._trans = rng.dirichlet(np.full(k, 0.05), size=k).astype(
            np.float32)
        self._k = k

    def batch_np(self, step: int) -> dict:
        """Global batch for `step` — deterministic."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._k, B)
        u = rng.random((B, S), np.float32)
        cdf = np.cumsum(self._trans, axis=1)
        for t in range(S):
            toks[:, t + 1] = np.argmax(
                cdf[toks[:, t]] > u[:, t:t + 1], axis=1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, device=None) -> dict:
        """`batch_np(step)` as int32 tensors on `device` (the CPU if None)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch_np(step).items()}
