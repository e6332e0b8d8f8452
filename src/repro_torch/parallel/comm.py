"""Collectives over the process group of one mesh axis, and the rank
launcher.

The reference's collectives are `shard_map`'s `psum` / `all_gather` /
`all_to_all` inside one traced program (`repro.parallel.compat` is a JAX
version shim with nothing to port).  In the port a rank is a process of
`torch.distributed`, and each collective here runs over the process group
of one mesh axis line (`sharding.Mesh.group`); an axis of size 1 has no
group, and a collective over it returns its input.

A dry-run mesh (`sharding.dry_mesh`) holds a `DryGroup` per axis: its
size and no processes.  A collective over one takes meta tensors, returns
the meta result of the right shape and exchanges nothing.

Every collective counts its calls and its result bytes by kind in `stats`
(the reference dry run's convention for collective traffic: the bytes of
each collective's result, per rank).

Transport: gloo.  Ranks that share one card cannot use NCCL (it refuses
two ranks on one GPU), so a CUDA tensor is copied to the host, collected
there, and copied back.  That staging is the transport on a shared card,
written out, not a fallback; `stats` counts it.  NCCL across cards is
later work (ROADMAP).

`spawn(fn, world)` starts `world` ranks with the spawn start method and a
gloo `file://` rendezvous in a fresh temporary directory; rank r runs on
`cuda:(r % device_count)` unless the caller names the CPU (one thread a
rank there).  An exception on any rank fails the whole run.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# how long a collective waits for a rank that never comes
RANK_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class CommStats:
    """What this rank's collectives did: calls, bytes copied between the
    card and the host around them, wall seconds inside them (staging
    included), and calls and result bytes by kind ("all-reduce",
    "all-gather", "all-to-all")."""
    calls: int = 0
    staged_bytes: int = 0
    seconds: float = 0.0
    kind_calls: dict = dataclasses.field(default_factory=dict)
    kind_bytes: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.staged_bytes, self.seconds = 0, 0, 0.0
        self.kind_calls, self.kind_bytes = {}, {}

    def count(self, kind: str, out: torch.Tensor) -> None:
        self.calls += 1
        self.kind_calls[kind] = self.kind_calls.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + \
            out.numel() * out.element_size()

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


stats = CommStats()


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """The group of a dry-run mesh axis line: `size` ranks, no processes."""
    size: int


def _dry(t: torch.Tensor, kind: str, shape) -> torch.Tensor:
    """A collective over a DryGroup: the meta result, counted."""
    if not t.is_meta:
        raise ValueError(f"a dry-run mesh's {kind} takes meta tensors, got "
                         f"one on {t.device}")
    out = torch.empty(shape, dtype=t.dtype, device="meta")
    stats.count(kind, out)
    return out


def _collect(t: torch.Tensor, kind: str, run) -> torch.Tensor:
    """Stage `t` on the host (a copy), `run(host)` -> the host result,
    bring it back to `t`'s device; counted in `stats`."""
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    host = src.cpu() if src.is_cuda else src.clone()
    out = run(host)
    stats.count(kind, out)
    if src.is_cuda:
        out = out.to(t.device)
        stats.staged_bytes += host.numel() * host.element_size() \
            + out.numel() * out.element_size()
    stats.seconds += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Elementwise `op` ("sum" or "max") of `t` over the group's ranks; a
    new tensor, `t` untouched."""
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry(t, "all-reduce", t.shape)

    def run(h):
        dist.all_reduce(h, op=_OPS[op], group=group)
        return h
    return _collect(t, "all-reduce", run)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ranks' `t` (equal shapes) concatenated along `dim`, in
    group-rank order."""
    if group is None:
        return t
    if isinstance(group, DryGroup):
        shape = list(t.shape)
        shape[dim] *= group.size
        return _dry(t, "all-gather", shape)

    def run(h):
        parts = [torch.empty_like(h)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim=dim)
    return _collect(t, "all-gather", run)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of `t`'s leading axis (split n ways) goes to group rank i;
    the result holds the chunks received, source rank by source rank,
    along the leading axis (`jax.lax.all_to_all(split_axis=0,
    concat_axis=0)`)."""
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry(t, "all-to-all", t.shape)

    def run(h):
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out
    return _collect(t, "all-to-all", run)


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


# ---------------------------------------------------------------------------
# rank launcher
# ---------------------------------------------------------------------------

def rank_device(rank: int, device=None) -> torch.device:
    """Rank r's device: `device` when the caller names one (the CPU),
    else `cuda:(r % device_count)` (all ranks on cuda:0 on one card)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch ranks run on a CUDA device and none is available; "
            "pass device='cpu' to run them on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, world, tmp, device, args):
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # one thread a rank: the ranks meet at every collective, so a
        # rank whose intra-op threads wait for a core stalls all of them
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world, timeout=RANK_TIMEOUT)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device=None):
    """Run `fn(rank, world, device, *args)` on `world` ranks (processes,
    spawn start method, gloo over a `file://` rendezvous in a fresh
    temporary directory) and return their return values, by rank.

    `fn` and `args` must be picklable (`fn` importable by name).  Every
    rank goes on the card unless `device` names the CPU.  If any rank
    raises, the others are stopped and the error is raised here."""
    import torch.multiprocessing as mp

    if device is None:
        rank_device(0)                   # no card: fail here, not per rank
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.start_processes(_rank_main, args=(fn, world, tmp, device, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
