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
there.  On a mesh (`TrainLayout`), every rank is given the same whole
parameters and draws the same global batch:
  * a `data` axis of n > 1 ranks: each rank takes its B/n rows and the
    gradients are averaged in full precision through
    `dp_trainer.make_dp_train_step(compress=False)` before AdamW, as the
    reference's GSPMD step reduces them;
  * a `model` axis: the parameters are split Megatron-style, as the mesh
    Engine splits them (`sharding.train_rules`: column-parallel
    wq/wk/wv/w_gate/w_up/unembed, row-parallel wo/w_down, the embedding
    and the norms whole, nothing over `data`: ZeRO-3 is ROADMAP queue 1
    item 16); the step runs the model's collectives under the training
    ctx, with their backward (`parallel.comm.copy_to` and friends), and
    AdamW updates each rank's blocks on the whole leaf's int8 block grid
    (`optim.adamw`).  Its loss, gradients and update are the
    single-device step's.
Checkpoints hold whole leaves, as the reference's do: the ranks of the
first `data` index gather each split leaf through the host, leaf by leaf,
and the first of them writes; a restore reads whole leaves and takes each
rank's blocks, so a checkpoint restores on any mesh (and the reference's
`ckpt.restore` reads it).  Every rank waits for the writer before a
restore.  A failure hook must raise on every rank at the same step: a
rank that raises alone leaves the others waiting in a collective for
`comm.RANK_TIMEOUT` (600 s).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.runtime import dp_trainer
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# leaves that stay whole on a model axis: a row gather on a vocab-split
# table would cost a collective per forward (as the mesh Engine keeps it)
WHOLE = (r"embedding$",)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def check_mesh(cfg, mesh) -> None:
    """Raise NotImplementedError for what training on `mesh` does not take
    yet: an axis other than `data` and `model`; under a `model` axis, a
    layer whose mixer is not `attn` (ROADMAP queue 1 item 18: the grouped
    column splits of mamba's and the xLSTM's weights, and the mixers' own
    collectives, have no training layout) or an attn+moe layer (item
    17)."""
    if mesh is None:
        return
    other = {a: n for a, n in mesh.shape.items()
             if a not in ("data", "model") and n > 1}
    if other:
        raise NotImplementedError(
            f"training over mesh axes {other} is not ported to repro_torch "
            f"(its meshes are data x model)")
    if mesh.shape.get("model", 1) == 1:
        return
    mixers = [s for s in cfg.layer_pattern if not s.startswith("attn+")]
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: training a {mixers[0]!r} layer under a model axis "
            f"is not ported to repro_torch yet (ROADMAP queue 1 item 18: "
            f"tensor-parallel training of mla, mamba, mlstm and slstm "
            f"layers; the tensor-parallel Trainer takes attn layers)")
    moe = [s for s in cfg.layer_pattern if s.endswith("+moe")]
    if moe:
        raise NotImplementedError(
            f"{cfg.name}: training a {moe[0]!r} layer under a model axis is "
            f"not ported to repro_torch yet (ROADMAP queue 1 item 17: the "
            f"expert-parallel collectives have no backward)")


def grads(params):
    """The parameters' gradients as a tree (zeros where autograd left
    none, as `jax.grad` gives for an unused leaf)."""
    return tree_map(lambda p: p.grad if p.grad is not None
                    else torch.zeros_like(p), params)


def release_grads(params) -> None:
    for p in tree_leaves(params):
        p.grad = None


class TrainLayout:
    """How one rank of a training mesh holds the state and takes a step
    (no mesh: the whole tree, no collectives).  `cfg` is the rank's model
    config (its heads and d_ff under a model axis), `splits` {param path:
    `sharding.Split` or None} once `shard` has placed the parameters.
    `step` is the step of the Trainer and of the dry run."""

    def __init__(self, cfg, mesh=None):
        check_mesh(cfg, mesh)
        self.mesh, self.cfg = mesh, cfg
        self.ctx = self.group = self.dp = None
        self.splits: dict = {}
        self.gathers = self.writer = True
        if mesh is None:
            return
        if mesh.coords is None:
            raise ValueError(f"this rank is outside the mesh {mesh.shape}")
        if mesh.shape.get("model", 1) > 1:
            self.ctx = sharding.ShardingCtx(mesh, sharding.train_rules(
                "pod" in mesh.axis_names))
            self.cfg = sharding.local_config(cfg, mesh, "model")
            self.group = mesh.group("model")
        if mesh.shape.get("data", 1) > 1:
            local = self.cfg
            self.dp = dp_trainer.make_dp_train_step(
                lambda p, b: M.loss_fn(p, b, local)[0], mesh, compress=False)
            self.gathers = mesh.index("data") == 0
        self.writer = self.gathers and (
            self.ctx is None or mesh.index("model") == 0)

    @property
    def ranks(self) -> int:
        return 1 if self.mesh is None else \
            self.mesh.shape.get("data", 1) * self.mesh.shape.get("model", 1)

    # -- placement ---------------------------------------------------------
    def shard(self, params):
        """This rank's blocks of the whole `params` (copies; the whole
        tree can be freed), noting each leaf's split."""
        if self.ctx is None:
            return params
        self.splits = sharding.leaf_splits(params, self.ctx, whole=WHOLE)
        return sharding.shard_params(params, self.ctx, whole=WHOLE)

    def _split_of(self, path: str):
        """(split, part) of a state-tree tensor: part "q" / "scale" for an
        int8 first moment's blocks / scales, "t" for the rest."""
        head, _, rest = path.partition("/")
        if head == "opt":
            rest = rest.partition("/")[2]           # m/<p> or v/<p>
        if rest in self.splits or not rest:
            return self.splits.get(rest), "t"
        return self.splits.get(rest[:-2]), "q" if rest.endswith("/0") \
            else "scale"

    def take(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole state-tree tensor at `key` (a
        {"params", "opt"} path)."""
        split, part = self._split_of(key)
        if split is None:
            return whole
        if part == "q":
            out = adamw.take_q(whole, split)
        elif part == "scale":
            out = adamw.take_scale(whole, split)
        else:
            out = split.take(whole)
        # a copy, so that the whole leaf can be freed
        return out.clone() if out.untyped_storage().nbytes() > \
            out.numel() * out.element_size() else out.contiguous()

    def gather(self, state):
        """The whole {"params", "opt"} tree on the host (each split leaf
        joined over the model axis through the host, leaf by leaf), on the
        ranks of the first data index; `state` itself without a model
        axis."""
        if self.ctx is None:
            return state

        def join(t, dim):
            return comm.all_gather(t.detach().cpu(), self.group, dim)

        def whole(key, t):
            split, part = self._split_of(key)
            if split is None:
                return t.detach().cpu()
            if part == "q":
                return adamw.gather_q(t, split, join)
            if part == "scale":
                return adamw.gather_scale(t, split, join).cpu()
            return join(t, split.dim)
        return tree_map_with_path(whole, state)

    # -- the step ------------------------------------------------------------
    def grads(self, params, batch, mark=lambda: None):
        """(gradient tree, loss, {"ce", "aux"} or {}) of one step: the loss
        forward and its backward (the data-parallel mean under a data
        axis), under the training ctx."""
        with sharding.use(self.ctx):
            if self.dp is not None:
                g, _, loss = self.dp(params, None, batch)
                mark()
                return g, loss, {}
            loss, parts = M.loss_fn(params, batch, self.cfg)
            mark()
            loss.backward()
            mark()
            return grads(params), loss.detach(), parts

    def step(self, params, opt_state, batch, opt_cfg: adamw.AdamWConfig,
             mark=lambda: None) -> dict:
        """One training step in place on `params` and `opt_state`, with
        `mark()` between its phases (the loss forward, its backward, AdamW
        with the gradients released; the data-parallel step's gradients
        come in one phase); returns the metrics."""
        g, loss, parts = self.grads(params, batch, mark)
        _, _, om = adamw.apply(params, opt_state, g, opt_cfg, self.splits,
                               self.group)
        if self.dp is None:
            release_grads(params)
        return {"loss": loss, **parts, **om}


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, params, opt_state=None,
                 mesh=None):
        """`params` (and `opt_state`, if given) are the whole trees: on a
        model axis each rank keeps its blocks of them."""
        self.layout = TrainLayout(cfg, mesh)
        self.cfg, self.tcfg = cfg, tcfg
        self._set_params(self.layout.shard(params))
        if opt_state is None:
            opt_state = adamw.init(self.params, tcfg.opt, self.layout.splits)
        elif self.layout.ctx is not None:
            opt_state = tree_map_with_path(
                lambda k, t: self.layout.take(f"opt/{k}", t), opt_state)
        self.opt_state = opt_state
        self.step = 0
        self.straggler_events: list[tuple[int, float]] = []
        self._ewma = None
        self._pending_ckpt = None

    def _set_params(self, params):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        self.params = params
        self.device = leaves[0].device

    def _train_step(self, batch) -> dict:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        out = self.layout.step(self.params, self.opt_state, batch,
                               self.tcfg.opt)
        return {k: v.detach() for k, v in out.items()}

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
        if not self.layout.gathers:
            return
        if force or (self.step and self.step % self.tcfg.ckpt_every == 0):
            tree = self.layout.gather(self.state_tree())
            if not self.layout.writer:
                return
            self._join_ckpt()
            self._pending_ckpt = ckpt.save(
                self.tcfg.ckpt_dir, self.step, tree,
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
        if self.layout.ranks > 1:
            # every rank restores what the writer has finished writing
            self._join_ckpt()
            comm.barrier()
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0
        take = self.layout.take if self.layout.ctx is not None else None
        tree = ckpt.restore(self.tcfg.ckpt_dir, step, self.state_tree(),
                            take=take)
        self._set_params(tree["params"])
        self.opt_state = tree["opt"]
        self.step = step
        return step

    # -- fault-tolerant loop ----------------------------------------------
    def train(self, pipeline, num_steps: int,
              failure_hook: Callable[[int], None] | None = None,
              max_restarts: int = 3) -> list[dict]:
        """Run to `num_steps`, recovering from exceptions via the last
        checkpoint.  `failure_hook(step)` may raise to inject faults; on a
        mesh it must raise on every rank at the same step (a rank that
        raises alone leaves the others in a collective until
        `comm.RANK_TIMEOUT`)."""
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
