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
parameters and draws the same global batch, and keeps its blocks of the
parameters and of the AdamW state under the reference's training rules
(`sharding.train_rules`, the reference's `default_rules`):
  * a `data` axis of n > 1 ranks is ZeRO-3: every leaf the rules cut on
    its `fsdp` dim (the in dim of column-parallel weights, the out dim of
    row-parallel ones, d of the experts and of the embedding), where n
    divides that dim, is held 1/n a rank, the parameter, its bf16 `v` and
    its int8 `m`'s blocks alike.  Each rank takes its B/n rows; the model
    gathers each period's leaves whole right before the block runs
    (`sharding.gather_uses`), autograd saves a gathered weight as its
    shard and gathers it again in backward (`comm.regather_saved`), and
    the gradient comes back reduce-scattered to the rank's block, summed
    and divided by n (`comm.gather_params`).  The leaves that stay whole
    (the norms, the router, a dim n does not divide) are averaged in one
    `all_reduce` over `data`, with the loss;
  * a `model` axis: the parameters are split Megatron-style, as the mesh
    Engine splits them (column-parallel wq/wk/wv/w_gate/w_up/unembed,
    row-parallel wo/w_down, the MoE expert stacks on E: the `expert`
    rule; mamba's `w_in` and the mLSTM's `w_up` in their column parts,
    the rank's block of each), and keeps whole what the mesh Engine keeps
    whole (`sharding.serve_whole`: the embedding, mamba's B/C and dt
    projections, the sLSTM's cell and its `w_up`; their `fsdp` cut over
    `data` stands); the step runs the model's collectives under the
    training ctx, with their backward (`parallel.comm.copy_to` and
    friends; a MoE layer's expert split in `models.moe`, or
    `parallel.ep.ep_moe` with `ep_dispatch="per_source"`; the mixers'
    own in `models.attention`, `models.mamba` and `models.xlstm`).  A few
    whole leaves are read by each rank through its own heads only, the
    mLSTM's gates and norm and the cross-attention's `kv_norm`
    (`model_partial`): their gradients are summed over `model` once a
    step.
AdamW updates each rank's blocks on the whole leaf's int8 block grid
(`optim.adamw`), reducing the norm and the spread block maxima over the
axes each leaf is cut over.  The step's loss, gradients and update are
the single-device step's.
Checkpoints hold whole leaves, as the reference's do: every rank gathers
each split leaf through the host, leaf by leaf, and the first rank
writes; a restore reads whole leaves and takes each rank's blocks, so a
checkpoint restores on any mesh (and the reference's `ckpt.restore`
reads it).  Every rank waits for the writer before a restore.  A failure
hook must raise on every rank at the same step: a rank that raises alone
leaves the others waiting in a collective for `comm.RANK_TIMEOUT` (600
s).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.tree import tree_items, tree_leaves, tree_map, \
    tree_map_with_path


def model_partial(cfg) -> tuple[str, ...]:
    """The leaves of `cfg` kept whole on a model axis whose gradient each
    rank's backward computes only in part, which the step sums over
    `model`: the mLSTM's `w_if`, `b_if` and `norm` (each rank keeps its
    heads' gates and its block of the normed h) and the cross-attention's
    `kv_norm` (each rank projects its KV heads from the normed vision
    embeddings).  The path names the pattern position: the sLSTM's norm
    and MLA's kv_norm get their whole gradient on every rank."""
    leaves = {"mlstm": r"(w_if|b_if|norm/scale)", "xattn": r"kv_norm/scale"}
    return tuple(rf"\bpos{i}/mixer/{leaves[mixer]}$"
                 for i, spec in enumerate(cfg.layer_pattern)
                 if (mixer := spec.split("+")[0]) in leaves)


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
    yet: an axis other than `data` and `model`.  Every layer kind trains
    on a data x model mesh."""
    if mesh is None:
        return
    other = {a: n for a, n in mesh.shape.items()
             if a not in ("data", "model") and n > 1}
    if other:
        raise NotImplementedError(
            f"{cfg.name}: training over mesh axes {other} is not ported to "
            f"repro_torch (its meshes are data x model)")


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
        self.ctx = None
        self.splits: dict = {}
        self.whole = sharding.serve_whole(cfg)
        self.partial = model_partial(cfg)
        self.writer = True
        if mesh is None or self.ranks == 1:
            return
        if mesh.coords is None:
            raise ValueError(f"this rank is outside the mesh {mesh.shape}")
        self.ctx = sharding.ShardingCtx(mesh, sharding.train_rules(
            "pod" in mesh.axis_names))
        self.cfg = sharding.local_config(cfg, mesh, "model")
        self.writer = not any(mesh.coords)

    @property
    def ranks(self) -> int:
        return 1 if self.mesh is None else \
            self.mesh.shape.get("data", 1) * self.mesh.shape.get("model", 1)

    @property
    def groups(self) -> dict:
        """{mesh axis: this rank's process group along it}."""
        return {} if self.ctx is None else self.mesh.groups

    # -- placement ---------------------------------------------------------
    def shard(self, params):
        """This rank's blocks of the whole `params` (copies; the whole
        tree can be freed), noting each leaf's split and, in the ctx, the
        cuts over `data` that the model gathers per use."""
        if self.ctx is None:
            return params
        self.splits = sharding.leaf_splits(params, self.ctx,
                                           whole=self.whole)
        dp = self.ctx.rules["fsdp"]
        self.ctx.zero = {path: c for path, s in self.splits.items()
                         if s is not None for c in s.cuts if c.axis in dp}
        return sharding.shard_params(params, self.ctx, whole=self.whole)

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

    def gather(self, state, keep: bool = True):
        """The whole {"params", "opt"} tree on the host: each split leaf
        joined over its axes through the host, leaf by leaf, every rank
        taking part; `state` itself without a mesh.  `keep=False` drops
        each whole leaf once joined (a rank that does not write: its host
        then holds one leaf at a time), leaving None."""
        if self.ctx is None:
            return state

        def join(t, cut):
            return comm.all_gather(t.detach().cpu(), self.groups[cut.axis],
                                   cut.dim)

        def whole(key, t):
            split, part = self._split_of(key)
            if split is None:
                out = t.detach().cpu()
            elif part == "q":
                out = adamw.gather_q(t, split, join)
            elif part == "scale":
                out = adamw.gather_scale(t, split, join).cpu()
            else:
                out = split.join(t, join)
            return out if keep else None
        return tree_map_with_path(whole, state)

    def barrier(self) -> None:
        """Wait for every rank of the mesh: a barrier along each axis in
        turn (a rank passes the last one only once the first rank has
        reached the first), so ranks outside the mesh are not waited
        for."""
        for axis in self.mesh.axis_names:
            if self.mesh.group(axis) is not None:
                comm.barrier(self.mesh.group(axis))

    # -- the step ------------------------------------------------------------
    def rows(self, batch) -> tuple[dict, bool]:
        """(this rank's rows of every batch leaf, whether they are a block
        of them): its block of B/n over `data` (`sharding.data_rows`), or
        all rows where n does not divide B, as the reference's batch rule
        leaves such a dim whole."""
        def take(t):
            lo, hi = sharding.data_rows(t.shape[0], self.mesh)
            return t[lo:hi]
        out = tree_map(take, batch)
        first = next(iter(batch.values())).shape[0]
        return out, next(iter(out.values())).shape[0] < first

    def _sum_over_model(self, params) -> None:
        """The `model_partial` leaves' gradients summed over `model`, in
        place: one `all_reduce` of all of them, packed in f32."""
        group = self.mesh.group("model")
        leaves = [p for path, p in tree_items(params)
                  if any(re.search(r, path) for r in self.partial)]
        if group is None or not leaves:
            return
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = comm.all_reduce(torch.cat([p.grad.reshape(-1).to(
            torch.float32) for p in leaves]), group, "sum")
        for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
            p.grad.copy_(g.view(p.shape))

    def _mean_over_data(self, params, metrics: dict) -> dict:
        """The data-parallel mean of the metrics and of the gradients of
        the leaves not cut over `data`, in place: one `all_reduce` of all
        of them, packed in f32."""
        group = self.mesh.group("data")
        if group is None:
            return metrics
        n = comm.group_size(group)
        whole = [p for path, p in tree_items(params)
                 if not (self.splits.get(path) and "data" in
                         self.splits[path].axes)]
        for p in whole:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([torch.stack([metrics[k].to(torch.float32)
                                       for k in sorted(metrics)])]
                         + [p.grad.reshape(-1).to(torch.float32)
                            for p in whole])
        flat = comm.all_reduce(flat, group, "sum") / n
        out = dict(zip(sorted(metrics), flat[:len(metrics)]))
        at = len(metrics)
        for p in whole:
            p.grad.copy_(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out

    def grads(self, params, batch, mark=lambda: None):
        """(gradient tree, loss, {"ce", "aux"}) of one step: the loss
        forward on this rank's rows and its backward under the training
        ctx (the weights gathered per use and their saves re-gathered
        under ZeRO-3), the `model_partial` leaves' gradients summed over
        `model`, and the data-parallel mean of the loss, its parts and the
        gradients."""
        ctx = self.ctx
        if ctx is not None:
            batch, split = self.rows(batch)
            ctx = dataclasses.replace(ctx, split_batch=split)
        saves = comm.regather_saved() if ctx is not None and ctx.zero \
            else contextlib.nullcontext()
        with sharding.use(ctx), saves:
            loss, parts = M.loss_fn(params, batch, self.cfg)
            mark()
            loss.backward()
        mark()
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if self.ctx is not None:
            self._sum_over_model(params)
            metrics = self._mean_over_data(params, metrics)
        loss = metrics.pop("loss")
        return grads(params), loss, metrics

    def step(self, params, opt_state, batch, opt_cfg: adamw.AdamWConfig,
             mark=lambda: None) -> dict:
        """One training step in place on `params` and `opt_state`, with
        `mark()` between its phases (the loss forward, its backward with
        the data-parallel mean, AdamW with the gradients released);
        returns the metrics."""
        g, loss, parts = self.grads(params, batch, mark)
        _, _, om = adamw.apply(params, opt_state, g, opt_cfg, self.splits,
                               self.groups)
        release_grads(params)
        return {"loss": loss, **parts, **om}


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, params, opt_state=None,
                 mesh=None):
        """`params` (and `opt_state`, if given) are the whole trees: on a
        mesh each rank keeps its blocks of them."""
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
        if force or (self.step and self.step % self.tcfg.ckpt_every == 0):
            tree = self.layout.gather(self.state_tree(),
                                      keep=self.layout.writer)
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
            self.layout.barrier()
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
