"""Fault-tolerant training runtime (port of `repro.runtime.trainer`).

Responsibilities:
  * `run_step`: loss and gradients through autograd, then the AdamW update
    in place under `torch.no_grad()` (leaf by leaf, in slices: no
    whole-tree f32 temporaries), the gradients released after each step,
  * periodic async checkpointing + pruning,
  * crash recovery: any exception (or injected failure) rolls back to the
    last checkpoint and replays — the data pipeline is stateless so the
    replay sees the same batches,
  * straggler watchdog: per-step wall-time EWMA; steps exceeding
    `straggler_factor ×` the EWMA are logged with the step index.

The parameters train on whatever device they live on; batches are moved
there.  With a mesh whose `data` axis has n > 1 ranks (every rank holding
the same parameters and drawing the same global batch), each rank takes
its B/n rows and the gradients are averaged in full precision through
`dp_trainer.make_dp_train_step(compress=False)` before AdamW, as the
reference's GSPMD step reduces them; the first rank of the axis writes the
checkpoints, and every rank waits for them before a restore.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.runtime import dp_trainer
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def check_mesh(mesh) -> None:
    """Training splits over a `data` axis only: raise NotImplementedError
    for a mesh whose other axes are larger than 1."""
    if mesh is None:
        return
    split = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
    if split:
        raise NotImplementedError(
            f"tensor-parallel training (mesh axes {split}) is not ported to "
            f"repro_torch yet (ROADMAP queue 1 item 11); a data axis trains "
            f"data-parallel")


def grads(params):
    """The parameters' gradients as a tree (zeros where autograd left
    none, as `jax.grad` gives for an unused leaf)."""
    return tree_map(lambda p: p.grad if p.grad is not None
                    else torch.zeros_like(p), params)


def release_grads(params) -> None:
    for p in tree_leaves(params):
        p.grad = None


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, params, opt_state=None,
                 mesh=None):
        check_mesh(mesh)
        self.cfg, self.tcfg = cfg, tcfg
        self._set_params(params)
        self.opt_state = opt_state or adamw.init(params, tcfg.opt)
        self.step = 0
        self.straggler_events: list[tuple[int, float]] = []
        self._ewma = None
        self._pending_ckpt = None
        self._dp, self._dp_group, self._writer = None, None, True
        if mesh is not None and mesh.shape.get("data", 1) > 1:
            self._dp = dp_trainer.make_dp_train_step(
                lambda p, b: M.loss_fn(p, b, cfg)[0], mesh, compress=False)
            self._dp_group = mesh.group("data")
            self._writer = mesh.index("data") == 0

    def _set_params(self, params):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        self.params = params
        self.device = leaves[0].device

    def _train_step(self, batch) -> dict:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self._dp is not None:
            g, _, loss = self._dp(self.params, None, batch)
            _, _, om = adamw.apply(self.params, self.opt_state, g,
                                   self.tcfg.opt)
            return {"loss": loss, **om}
        loss, parts = M.loss_fn(self.params, batch, self.cfg)
        loss.backward()
        _, _, om = adamw.apply(self.params, self.opt_state,
                               grads(self.params), self.tcfg.opt)
        release_grads(self.params)
        return {"loss": loss.detach(), **{k: v.detach()
                                           for k, v in parts.items()}, **om}

    # -- one step with watchdog ------------------------------------------
    def run_step(self, batch) -> dict:
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in self._train_step(batch).items()}
        dt = time.perf_counter() - t0
        if self._ewma is None:
            self._ewma = dt
        elif dt > self.tcfg.straggler_factor * self._ewma and self.step > 3:
            self.straggler_events.append((self.step, dt))
        self._ewma = 0.9 * (self._ewma or dt) + 0.1 * dt
        self.step += 1
        return metrics

    # -- checkpointing ----------------------------------------------------
    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def maybe_checkpoint(self, force=False):
        if not self._writer:
            return
        if force or (self.step and self.step % self.tcfg.ckpt_every == 0):
            self._join_ckpt()
            self._pending_ckpt = ckpt.save(
                self.tcfg.ckpt_dir, self.step, self.state_tree(),
                blocking=not self.tcfg.async_ckpt)
            if self._pending_ckpt is None:
                ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.keep)

    def _join_ckpt(self):
        """Wait for the pending async save, then prune.  Pruning only once
        a save has completed keeps it from racing the writer, which
        replaces an existing step's directory (remove, then rename) and
        would hide it from a prune that lists the directory meanwhile."""
        if self._pending_ckpt is not None:
            self._pending_ckpt.join()
            self._pending_ckpt = None
            ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.keep)

    def restore_latest(self) -> int:
        if self._dp is not None:
            # every rank restores what the writer has finished writing
            self._join_ckpt()
            comm.barrier(self._dp_group)
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0
        tree = ckpt.restore(self.tcfg.ckpt_dir, step, self.state_tree())
        self._set_params(tree["params"])
        self.opt_state = tree["opt"]
        self.step = step
        return step

    # -- fault-tolerant loop ----------------------------------------------
    def train(self, pipeline, num_steps: int,
              failure_hook: Callable[[int], None] | None = None,
              max_restarts: int = 3) -> list[dict]:
        """Run to `num_steps`, recovering from exceptions via the last
        checkpoint.  `failure_hook(step)` may raise to inject faults."""
        history: list[dict] = []
        restarts = 0
        while self.step < num_steps:
            try:
                while self.step < num_steps:
                    batch = pipeline.batch(self.step, self.device)
                    if failure_hook is not None:
                        failure_hook(self.step)
                    history.append(self.run_step(batch))
                    self.maybe_checkpoint()
            except Exception:
                restarts += 1
                if restarts > max_restarts:
                    raise
                # roll back to the last durable state and replay
                self._join_ckpt()
                self.restore_latest()
        self.maybe_checkpoint(force=True)
        self._join_ckpt()
        return history
