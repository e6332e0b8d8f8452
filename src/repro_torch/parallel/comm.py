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
("all-reduce", "all-gather", "all-to-all", "reduce-scatter"; the
reference dry run's convention for collective traffic: the bytes of each
collective's result, per rank), and its calls by the mesh axis of its
group (`name_group`).  `all_gather_many` gathers several tensors of any
dtypes in one collective: the mesh Engine's one exchange over `data` a
forward (the pool rows a rank wrote and the tokens it sampled).

The collectives above detach their input, but for `all_to_all`, whose
backward is the same exchange: serving and the dry run's forwards need
no gradient through them.  Training a `model`-split model needs three
more that autograd passes through (Megatron-LM's conjugate pairs,
for a loss that every rank of the group computes alike): `copy_to`
(identity forward, the gradient summed over the group: Megatron's *f*),
`reduce_from` (a sum forward, the gradient passed through: *g*) and
`gather_from` (an all-gather forward, this rank's slice of the gradient
back).  Each counts the collective it runs in `stats`, forward or
backward, and works over a `DryGroup` on meta tensors too.

ZeRO-3 training over `data`, where every rank computes its own loss on
its own rows, needs two more: `all_gather_grad` (an all-gather whose
backward is its conjugate, the `reduce_scatter` sum of every rank's
gradient: a MoE layer's input, routed on the whole batch) and
`gather_params` (the same with the sum divided by the group's size: a
weight gathered whole for one use, its gradient the data-parallel mean
of this rank's block).  `regather_saved` keeps such a gathered weight
from living until its backward: autograd saves it as its shard and
gathers it again when the backward needs it.

Transport: gloo.  Ranks that share one card cannot use NCCL (it refuses
two ranks on one GPU), so a CUDA tensor is copied to pinned host memory,
collected there, and copied back.  That staging is the transport on a
shared card, written out, not a fallback; `stats` counts it.  A
collective of more than `LANE_BYTES` a rank splits its bytes over the
`LANES` process groups its mesh made for the axis line (`add_lanes`),
run at once: one gloo pair of connections is the bottleneck of a large
transfer.  NCCL across cards is later work (ROADMAP).

`spawn(fn, world)` starts `world` ranks with the spawn start method and a
gloo `file://` rendezvous in a fresh temporary directory; rank r runs on
`cuda:(r % device_count)` unless the caller names the CPU (one thread a
rank there).  An exception on any rank fails the whole run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the single-tensor all-gather and reduce-scatter (`all_gather_into_tensor`
# and `reduce_scatter_tensor`, renamed `*_single` in newer torch releases)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
# how long a collective waits for a rank that never comes
RANK_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class CommStats:
    """What this rank's collectives did: calls, bytes copied between the
    card and the host around them, wall seconds inside them (staging
    included), and calls and result bytes by kind ("all-reduce",
    "all-gather", "all-to-all", "reduce-scatter")."""
    calls: int = 0
    staged_bytes: int = 0
    seconds: float = 0.0
    kind_calls: dict = dataclasses.field(default_factory=dict)
    kind_bytes: dict = dataclasses.field(default_factory=dict)
    axis_calls: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.staged_bytes, self.seconds = 0, 0, 0.0
        self.kind_calls, self.kind_bytes, self.axis_calls = {}, {}, {}

    def count(self, kind: str, out: torch.Tensor, group=None) -> None:
        self.calls += 1
        self.kind_calls[kind] = self.kind_calls.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + \
            out.numel() * out.element_size()
        axis = axis_of(group)
        self.axis_calls[axis] = self.axis_calls.get(axis, 0) + 1

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


stats = CommStats()


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """The group of a dry-run mesh axis line: `size` ranks, no processes,
    along the mesh axis `axis`."""
    size: int
    axis: str | None = None


# the mesh axis of each process group a mesh made (`sharding.Mesh`)
_AXES: dict = {}
# a collective of more than LANE_BYTES a rank splits its bytes over LANES
# process groups of its axis line, each with its own gloo connections and
# thread, run at once: one gloo pair of connections is the bottleneck of a
# large host-staged transfer (chip_smoke.py's phase 15i reads the step)
LANES = 8
LANE_BYTES = 4 << 20
_LANES: dict = {}


def name_group(group, axis: str):
    """Note `group` as a line along mesh axis `axis`; returns the group."""
    _AXES[id(group)] = axis
    return group


def axis_of(group) -> str | None:
    """The mesh axis `group` runs along (None for an unnamed group)."""
    if isinstance(group, DryGroup):
        return group.axis
    return _AXES.get(id(group))


def _dry(t: torch.Tensor, kind: str, shape, group=None) -> torch.Tensor:
    """A collective over a DryGroup: the meta result, counted."""
    if not t.is_meta:
        raise ValueError(f"a dry-run mesh's {kind} takes meta tensors, got "
                         f"one on {t.device}")
    out = torch.empty(shape, dtype=t.dtype, device="meta")
    stats.count(kind, out, group)
    return out


def add_lanes(group, lanes) -> None:
    """Note `lanes`, process groups over the same ranks as `group`, as the
    extra lanes a large collective over `group` splits its bytes across
    (`sharding.Mesh` gives each axis line LANES in all)."""
    _LANES[id(group)] = [group] + list(lanes)


def _spans(group, numel: int, elem: int) -> list:
    """[(lane group, lo, hi)] of a rank's block of `numel` elements: one
    span over `group` itself, or, past LANE_BYTES, equal spans (the last
    shorter or empty) over each of its lanes."""
    lanes = _LANES.get(id(group), [group])
    k = len(lanes) if numel * elem > LANE_BYTES else 1
    step = -(-numel // k)
    return [(lanes[j], j * step, min((j + 1) * step, numel))
            for j in range(k)]


def _wait(works) -> None:
    for w in works:
        w.wait()


# the pinned host buffers a CUDA collective stages through ("in": the
# rank's copy, "out": the result), kept and grown to the largest call, so a
# collective allocates no pinned memory once they have grown (pinning is
# slow); its result is copied to the device before the next one starts
_STAGING: dict = {}


def _empty(shape, dtype, pinned: bool, slot: str) -> torch.Tensor:
    """An uninitialised host tensor: a view of the pinned staging buffer
    `slot` when `pinned`, else a fresh one."""
    if not pinned:
        return torch.empty(shape, dtype=dtype)
    n = math.prod(shape) * dtype.itemsize
    buf = _STAGING.get(slot)
    if buf is None or buf.numel() < n:
        old = 0 if buf is None else buf.numel()
        _STAGING[slot] = buf = None
        buf = torch.empty((max(n, 2 * old),), dtype=torch.uint8,
                          pin_memory=True)
        _STAGING[slot] = buf
    return buf[:n].view(dtype).view(shape)


def _host(src: torch.Tensor, numel: int | None = None) -> torch.Tensor:
    """`src` as a flat host copy of `numel` (>= its size) elements, the
    rest zero: in the pinned "in" buffer for a CUDA tensor (the copy runs
    at the link's rate), a plain copy of a CPU one."""
    flat = src.reshape(-1)
    numel = flat.numel() if numel is None else numel
    host = _empty((numel,), src.dtype, src.is_cuda, "in")
    host[:flat.numel()].copy_(flat)
    host[flat.numel():].zero_()
    return host


def _collect(t: torch.Tensor, kind: str, run, group=None, pre=None,
             post=None) -> torch.Tensor:
    """Stage `t` (after `pre(t)`, on its device) on the host and collect
    it there: `run(src)` -> (the host copy, the host result); bring the
    result back to `t`'s device and apply `post` there; counted in
    `stats` (the staged bytes: the host copy in and the result out)."""
    t0 = time.perf_counter()
    src = t.detach()
    if pre is not None:
        src = pre(src)
    host, out = run(src)
    if t.is_cuda:
        stats.staged_bytes += host.numel() * host.element_size() \
            + out.numel() * out.element_size()
        out = out.to(t.device)
    if post is not None:
        out = post(out)
    stats.count(kind, out, group)
    stats.seconds += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Elementwise `op` ("sum" or "max") of `t` over the group's ranks; a
    new tensor, `t` untouched."""
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry(t, "all-reduce", t.shape, group)

    def run(src):
        h = _host(src)
        _wait([dist.all_reduce(h[lo:hi], op=_OPS[op], group=g,
                               async_op=True)
               for g, lo, hi in _spans(group, h.numel(), h.element_size())
               if hi > lo])
        return h, h
    return _collect(t, "all-reduce", run, group,
                    post=lambda out: out.view(t.shape))


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ranks' `t` (equal shapes) concatenated along `dim`, in
    group-rank order.  A large block is gathered in spans, one a lane,
    into a (lanes, n, span) buffer, reordered on `t`'s device."""
    if group is None:
        return t
    if isinstance(group, DryGroup):
        shape = list(t.shape)
        shape[dim] *= group.size
        return _dry(t, "all-gather", shape, group)
    dim %= t.ndim
    n, numel = group_size(group), t.numel()
    spans = _spans(group, numel, t.element_size())
    k, step = len(spans), spans[0][2] - spans[0][1]

    def run(src):
        h = _host(src, k * step)
        out = _empty((k, n, step), h.dtype, src.is_cuda, "out")
        _wait([_ALL_GATHER(out[j].view(-1), h[j * step:(j + 1) * step],
                           group=g, async_op=True)
               for j, (g, _, _) in enumerate(spans)])
        return h, out

    def post(out):
        whole = out.transpose(0, 1).reshape(n, k * step)[:, :numel]
        whole = whole.reshape((n,) + tuple(t.shape)).movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= n
        return whole.reshape(shape)
    return _collect(t, "all-gather", run, group, post=post)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the group's ranks' `t` (equal shapes), of which group
    rank i keeps block i of n along `dim`.  A large block is reduced in
    spans, one a lane: `t` is reordered on its device into (lanes, n,
    span) first."""
    if group is None:
        return t
    dim %= t.ndim
    shape = list(t.shape)
    shape[dim] //= group_size(group)
    if isinstance(group, DryGroup):
        return _dry(t, "reduce-scatter", shape, group)
    n, numel = group_size(group), math.prod(shape)
    spans = _spans(group, numel, t.element_size())
    k, step = len(spans), spans[0][2] - spans[0][1]

    def pre(src):
        x = src.movedim(dim, 0).reshape(n, numel)
        if k * step > numel:
            x = torch.nn.functional.pad(x, (0, k * step - numel))
        return x.reshape(n, k, step).transpose(0, 1)

    def run(src):
        h = _host(src).view(k, n * step)
        out = _empty((k, step), h.dtype, src.is_cuda, "out")
        _wait([_REDUCE_SCATTER(out[j], h[j], group=g, async_op=True)
               for j, (g, _, _) in enumerate(spans)])
        return h, out

    def post(out):
        block = list(t.shape)
        block[dim] = shape[dim]
        block = [block[dim]] + block[:dim] + block[dim + 1:]
        return out.reshape(-1)[:numel].reshape(block).movedim(0, dim) \
            .contiguous()
    return _collect(t, "reduce-scatter", run, group, pre=pre, post=post)


def group_size(group) -> int:
    """The ranks of `group` (1 for None)."""
    if group is None:
        return 1
    if isinstance(group, DryGroup):
        return group.size
    return dist.get_world_size(group)


def all_gather_many(tensors, group) -> list:
    """`all_gather` along dim 0 of each of `tensors` (any dtypes, equal
    shapes across the group's ranks), in ONE collective: their bytes are
    packed into one buffer, gathered, and cut back into each tensor's
    ranks' parts.  Counted as one all-gather."""
    tensors = list(tensors)
    if group is None:
        return tensors
    if isinstance(group, DryGroup):
        n = sum(t.numel() * t.element_size() for t in tensors)
        _dry(torch.empty((n,), dtype=torch.uint8, device="meta"),
             "all-gather", (n * group.size,), group)
        return [torch.empty((t.shape[0] * group.size,) + tuple(t.shape[1:]),
                            dtype=t.dtype, device="meta") for t in tensors]
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    sizes = [f.numel() for f in flat]
    whole = all_gather(torch.cat(flat), group).reshape(-1, sum(sizes))
    out, at = [], 0
    for t, n in zip(tensors, sizes):
        part = whole[:, at:at + n].contiguous().view(t.dtype)
        out.append(part.reshape((-1,) + tuple(t.shape[1:])))
        at += n
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of `t`'s leading axis (split n ways) goes to group rank i;
    the result holds the chunks received, source rank by source rank,
    along the leading axis (`jax.lax.all_to_all(split_axis=0,
    concat_axis=0)`).  Autograd passes through it: the exchange is its
    own transpose (chunk j of rank i's result is chunk i of rank j's
    input), so its backward is the same exchange of the gradient."""
    if group is None:
        return t
    return _AllToAll.apply(t, group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    if isinstance(group, DryGroup):
        return _dry(t, "all-to-all", t.shape, group)

    def run(src):
        h = _host(src).view(src.shape)
        out = _empty(h.shape, h.dtype, src.is_cuda, "out")
        dist.all_to_all_single(out, h, group=group)
        return h, out
    return _collect(t, "all-to-all", run, group)


# ---------------------------------------------------------------------------
# collectives autograd passes through (tensor-parallel training)
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "sum"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, index):
        ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, mean):
        ctx.group, ctx.dim, ctx.mean = group, dim, mean
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter(g, ctx.group, ctx.dim)
        if ctx.mean:
            out = out.div_(group_size(ctx.group))
        return out, None, None, None


def all_gather_grad(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`all_gather` along `dim` whose backward is its conjugate: this
    rank's block of the sum of every rank's gradient (`reduce_scatter`),
    for a result each rank uses in its own loss."""
    if group is None:
        return t
    return _Gather.apply(t, group, dim % t.ndim, False)


def gather_params(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A weight block `t` gathered whole along `dim` for one use; in
    backward this rank's block of the ranks' gradients, summed and divided
    by the group's size (the data-parallel mean of ZeRO-3).  The result
    notes its source, so that `regather_saved` saves it as `t`."""
    if group is None:
        return t
    out = _Gather.apply(t, group, dim % t.ndim, True)
    src = (t.detach(), group, dim % t.ndim)
    out._gathered_from = src
    if out._base is not None:            # the buffer the gather filled
        out._base._gathered_from = src
    return out


class _Regather:
    """A saved view of a weight `gather_params` gathered: its source and
    the view's geometry in the whole weight."""
    __slots__ = ("src", "size", "stride", "offset")

    def __init__(self, src, t):
        self.src, self.size = src, t.size()
        self.stride, self.offset = t.stride(), t.storage_offset()


@contextlib.contextmanager
def regather_saved():
    """Inside the block, autograd saves each tensor that is (a view of) a
    weight gathered by `gather_params` as its source block, and the
    backward gathers it again when it unpacks it (one all-gather; the
    weight last gathered so is kept until another is needed, so a run of
    saves of one weight gathers it once).  Other tensors are saved as
    they are.  The whole weights then live for their use only: at most a
    block of them at a time, forward or backward."""
    last = [None, None]

    def pack(t):
        src = getattr(t, "_gathered_from", None)
        if src is None and t._base is not None:
            src = getattr(t._base, "_gathered_from", None)
        return t if src is None else _Regather(src, t)

    def unpack(p):
        if not isinstance(p, _Regather):
            return p
        if last[0] is not p.src:
            last[1] = None                        # free the previous one
            shard, group, dim = p.src
            last[:] = p.src, all_gather(shard, group, dim)
        return last[1].as_strided(p.size, p.stride, p.offset)

    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        last[:] = None, None


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """`t` unchanged; in backward the gradient is summed over the group
    (the input of a column-parallel block, whose ranks each see part of
    its consumers)."""
    if group is None:
        return t
    return _CopyTo.apply(t, group)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce` sum whose backward passes the (replicated) gradient to
    every rank's partial unchanged."""
    if group is None:
        return t
    return _ReduceFrom.apply(t, group)


def gather_from(t: torch.Tensor, group, dim: int, index: int) -> torch.Tensor:
    """`all_gather` along `dim` whose backward hands this rank (group rank
    `index`) its own slice of the replicated gradient; no collective."""
    if group is None:
        return t
    return _GatherFrom.apply(t, group, dim % t.ndim, index)


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
