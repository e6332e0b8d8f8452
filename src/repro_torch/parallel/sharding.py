"""Logical-axis sharding: DP / FSDP(ZeRO-3) / TP / EP / SP rules, the mesh
of ranks, and parameter placement (port of `repro.parallel.sharding`).

Rule sets map logical axis names → physical mesh axes, as the
reference's:

  batch    : data-parallel batch dim            → ("pod", "data")
  fsdp     : ZeRO-3 parameter shard dim         → ("pod", "data")
  tp       : tensor-parallel (heads/ff/vocab)   → "model"
  act_seq  : sequence-parallel residual stream  → "model"
  kv_feat  : decode KV-cache feature shard      → "model"

Parameter placement is name-based: `spec_for(path, ndim)` assigns (fsdp,
tp) on the (in, out) dims of column-parallel weights, (tp, fsdp) on
row-parallel ones, experts on (tp→EP, fsdp, ·), everything else
replicated; stacked layer params get a leading None for the period axis.
The rules are the reference's: attention, the dense FF, MoE, MLA, mamba
and xLSTM.  `serve_rules` maps `fsdp` to nothing (weights split over
`model` only, replicated over `data`); `train_rules` maps it to the DP
axes, as `default_rules` does: training is ZeRO-3, every large weight cut
once more over `data` on the dim the rules name `fsdp`.  `leaf_splits`
notes each leaf's `Split` (one `Cut` per mesh axis it is cut over) for
the training state's optimizer and checkpoints, and `gather_leaf` gathers
a leaf's `fsdp` cut back for one use (`ShardingCtx.zero`).

Three weights concatenate parts along their output columns: mamba's
`w_in` ([x | z]), the mLSTM's and sLSTM's `w_up` ([xm | z], [a | b]) and
the sLSTM's `w_gates` ([z, i, f, o]).  `shard_params` splits each part on
its own (`_GROUPED`), so that rank r holds block r of every part and the
model code chunks its local output as it chunks the whole one; in
training such a leaf's `Cut` carries its `parts`, and its `Split`
addresses the rank's block of each part.  The mesh Engine and the
Trainer keep some leaves whole on `model` that the reference's rules
split (`serve_whole`; a training leaf's `fsdp` cut over `data` stands):
the embedding, mamba's `w_bc` / `w_dt_down` / `w_dt_up` (the reference
splits `w_bc` and `w_dt_down` by rows), the sLSTM's recurrent cell
(`w_gates`, `r_gates`) and its `w_up`; the mixers' docstrings say why.

What differs from the reference: a mesh here is a grid of
`torch.distributed` ranks (processes), not of devices in one program.
`Mesh` holds this rank's coordinates and one process group per axis line
it sits on; `shard_params` slices each leaf to this rank's block (the
counterpart of `param_shardings` + `jax.device_put`).  `constrain` has no
counterpart: the port partitions explicitly — the model code calls the
collectives of `parallel.tp` / `parallel.ep` where the reference lets
GSPMD insert them.  The batch rule's one placement that the port keeps is
`data_rows`: the block of batch rows (the Engine's slots) a rank of the
`data` axis computes, or all of them where `constrain` would leave the
dim whole; a ctx with `split_batch` set runs its forwards on that block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import warnings
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.comm import DryGroup
from repro_torch.tree import tree_map_with_path

_AXIS_ORDER = ("pod", "data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (pod ×) data × model grid of ranks, row-major over the axes (rank
    r sits at the r-th cell).  `coords` is this rank's cell (None for a
    rank left outside an underfilled mesh); `groups[axis]` the process
    group of the line through it along `axis` (None when the axis has size
    1, which needs no collective)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...] | None
    groups: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (`jax.lax.axis_index`)."""
        if self.coords is None:
            raise ValueError("this rank is outside the mesh")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)


def _rank_grid(sizes):
    """Every cell of the grid, row-major, as a coordinate tuple."""
    cells = [()]
    for s in sizes:
        cells = [c + (i,) for c in cells for i in range(s)]
    return cells


def _make_mesh(axes, sizes) -> Mesh:
    """The mesh over the first prod(sizes) ranks of the default group, and
    its axis-line groups (each with `comm.LANES - 1` more groups over the
    same ranks: the lanes of its large collectives).  Every rank of the
    default group takes part in every `new_group` call, members or not,
    in the same order."""
    cells = _rank_grid(sizes)
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = cells[rank] if rank < len(cells) else None
    groups = {}
    for a, axis in enumerate(axes):
        if sizes[a] == 1:
            continue
        lines = {}
        for r, c in enumerate(cells):
            lines.setdefault(c[:a] + c[a + 1:], []).append(r)
        for key in sorted(lines):
            g = dist.new_group(lines[key])
            lanes = [dist.new_group(lines[key])
                     for _ in range(comm.LANES - 1)]
            if coords is not None and coords[:a] + coords[a + 1:] == key:
                groups[axis] = comm.name_group(g, axis)
                comm.add_lanes(g, lanes)
    return Mesh(tuple(axes), tuple(sizes), coords, groups)


@dataclasses.dataclass
class ShardingCtx:
    """A mesh and its rules.  `split_batch`: the forwards under this ctx
    run on this rank's `data_rows` block of the batch (the mesh Engine's
    slot split, a training rank's rows), so a layer whose result depends
    on every row of the call (MoE routing and capacity) gathers its input
    over `data` first.  `zero`: {param path: `Cut`} of the leaves a ZeRO-3
    training rank holds cut over a DP axis, which the model gathers whole
    right before each use (`gather_leaf`); empty outside training."""
    mesh: Mesh
    rules: dict
    split_batch: bool = False
    zero: dict = dataclasses.field(default_factory=dict)

    def resolve(self, *logical) -> tuple:
        """The physical axes (or None) of each logical axis name."""
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)

    def phys_axis(self, logical: str) -> str | None:
        """The single physical mesh axis `logical` maps to, or None when the
        rule is absent, multi-axis, or names an axis this mesh doesn't have
        (callers use this to decide whether a collective path can run)."""
        phys = self.rules.get(logical)
        if isinstance(phys, str) and phys in self.mesh.axis_names:
            return phys
        return None


_ACTIVE: ShardingCtx | None = None


def default_rules(multi_pod: bool) -> dict:
    dp = ("pod", "data") if multi_pod else ("data",)
    return {"batch": dp, "fsdp": dp, "tp": "model",
            "act_seq": "model", "kv_feat": "model", "expert": "model"}


def serve_rules(multi_pod: bool) -> dict:
    """Inference sharding profile: weights tensor-parallel over `model`
    only, replicated across the DP axes."""
    r = default_rules(multi_pod)
    r["fsdp"] = None
    return r


def train_rules(multi_pod: bool) -> dict:
    """Training sharding profile, the reference's `default_rules`: weights
    (and their AdamW moments) tensor-parallel over `model` and ZeRO-3 over
    the DP axes (`fsdp`), each rank holding 1/n of every leaf the rules
    cut where n divides the dim."""
    return default_rules(multi_pod)


def _world_size() -> int:
    """The ranks a mesh can use: the default group's size, 1 without one
    (the counterpart of the reference's device count)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _parse(spec) -> dict:
    named = {}
    s = str(spec).strip()
    if "=" in s:
        for part in s.split(","):
            name, _, val = part.partition("=")
            if name.strip() not in _AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name.strip()!r} "
                                 f"(expected {_AXIS_ORDER})")
            named[name.strip()] = int(val)
    elif "x" in s:
        dims = [int(v) for v in s.split("x")]
        if len(dims) not in (2, 3):
            raise ValueError(f"mesh spec {s!r} must be 2-D or 3-D")
        named = dict(zip(_AXIS_ORDER[-len(dims):], dims))
    else:
        named = {"model": int(s)}
    return named


def spec_ranks(spec) -> int:
    """The ranks a `build_mesh` spec asks for, an omitted `data` axis
    taken as 1: what the launchers spawn for `--shard SPEC`."""
    n = 1
    for v in _parse(spec).values():
        n *= v
    return n


def build_mesh(spec: str | int | None = None, *, pod: int | None = None,
               data: int | None = None, model: int | None = None) -> Mesh:
    """2-D/3-D mesh builder over (pod ×) data × model, with the
    reference's specs, keywords, errors and warning:

      build_mesh(4)  / build_mesh("4")       → data-filled × 4-way model
      build_mesh("2x4") / build_mesh("2x2x2")→ (data, model) / (pod, data,
                                               model) shapes
      build_mesh("data=2,model=4")           → named axes, any subset
      build_mesh(model=4)                    → keyword form of the same

    "Devices" are the ranks of the default process group (1 without one).
    An omitted `data` is filled with the remaining ranks; `pod` appears
    only when requested.  Every rank of the group must call this, with the
    same arguments (it creates the axis groups)."""
    if spec is not None:
        if pod is not None or data is not None or model is not None:
            raise ValueError("pass a spec or keyword axes, not both")
        pod, data, model = (_parse(spec).get(a) for a in _AXIS_ORDER)
    for name, val in zip(_AXIS_ORDER, (pod, data, model)):
        if val is not None and val < 1:
            raise ValueError(f"mesh axis {name}={val} must be >= 1 "
                             f"(omit the axis to disable it)")
    data_explicit = data is not None
    devs = _world_size()
    model = model or 1
    fixed = (pod or 1) * model
    if data is None:
        if devs % fixed:
            raise ValueError(f"{devs} devices not divisible by "
                             f"pod*model={fixed}")
        data = devs // fixed
    shape = tuple(v for v in (pod, data, model) if v is not None)
    axes = tuple(a for a, v in zip(_AXIS_ORDER, (pod, data, model))
                 if v is not None)
    need = 1
    for v in shape:
        need *= v
    if need > devs:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} "
                         f"devices, only {devs} available")
    if need < devs and data_explicit:
        warnings.warn(f"mesh {dict(zip(axes, shape))} uses {need} of "
                      f"{devs} devices", stacklevel=2)
    return _make_mesh(axes, shape)


def dry_mesh(spec: str | int | None = None) -> Mesh:
    """A dry-run mesh (the counterpart of the reference's
    `make_production_mesh`): the grid a `build_mesh` spec names, with
    sizes and no processes.  It is rank 0's view, every axis line a
    `comm.DryGroup`; an omitted `data` or `model` is 1 (as `build_mesh`
    always has a model axis).  Collectives over it take meta tensors and
    exchange nothing (`parallel.comm`)."""
    named = _parse(spec) if spec is not None else {}
    for name, val in named.items():
        if val < 1:
            raise ValueError(f"mesh axis {name}={val} must be >= 1")
    named.setdefault("data", 1)
    named.setdefault("model", 1)
    axes = tuple(a for a in _AXIS_ORDER if a in named)
    sizes = tuple(named[a] for a in axes)
    return Mesh(axes, sizes, (0,) * len(axes),
                {a: DryGroup(n, a) for a, n in zip(axes, sizes) if n > 1})


def activate(mesh: Mesh, rules: dict | None = None) -> ShardingCtx:
    global _ACTIVE
    multi_pod = "pod" in mesh.axis_names
    _ACTIVE = ShardingCtx(mesh, rules or default_rules(multi_pod))
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> ShardingCtx | None:
    return _ACTIVE


@contextlib.contextmanager
def use(ctx: ShardingCtx | None):
    """`ctx` active inside the block (nothing changes for None), the
    previous one restored after it."""
    global _ACTIVE
    if ctx is None:
        yield
        return
    before, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = before


def data_rows(rows: int, mesh: Mesh | None) -> tuple[int, int]:
    """[lo, hi) of the `rows` batch rows (the Engine's slots) that this
    rank of `mesh` computes: its block of rows/n along the `data` axis
    when n divides `rows`, else all of them, as the reference's
    `constrain` leaves a dim that does not divide whole.  The mesh Engine,
    `launch/specs.rank_batch` and the dry run's per-rank batch take it
    from here."""
    n = 1 if mesh is None else mesh.shape.get("data", 1)
    if n == 1 or rows % n:
        return 0, rows
    b = rows // n
    i = mesh.index("data")
    return i * b, (i + 1) * b


def batch_group():
    """The `data` group the active ctx's forwards split their batch over
    (`ShardingCtx.split_batch`), else None."""
    if _ACTIVE is None or not _ACTIVE.split_batch:
        return None
    return _ACTIVE.mesh.group("data")


def gather_leaf(t: torch.Tensor, path: str, drop: int = 0) -> torch.Tensor:
    """The leaf at param `path` whole over the active ctx's DP axes for one
    use: `comm.gather_params` along its `fsdp` cut (`ShardingCtx.zero`),
    whose backward reduce-scatters the gradient back to this rank's block
    (the data-parallel mean).  `drop`: leading dims of the stacked leaf
    that `t` has lost (1 for one period's view).  `t` itself when no ctx
    cuts the leaf over data: serving and the meshless step pay one dict
    lookup."""
    cut = None if _ACTIVE is None else _ACTIVE.zero.get(path)
    if cut is None:
        return t
    return comm.gather_params(t, _ACTIVE.mesh.group(cut.axis),
                              cut.dim - drop)


def gather_uses(tree: dict, prefix: str, drop: int = 0) -> dict:
    """`gather_leaf` of every tensor of the dict `tree` (params at
    `prefix`): one block's weights, gathered right before the block
    runs."""
    if _ACTIVE is None or not _ACTIVE.zero:
        return tree
    return tree_map_with_path(
        lambda k, t: gather_leaf(t, f"{prefix}/{k}", drop), tree)


def tp_axis() -> str | None:
    """The mesh axis the active ctx's `tp` rule splits weights over (its
    size > 1), else None: where the model's row-parallel linears and the
    unembed's gather take their collectives."""
    if _ACTIVE is None:
        return None
    ax = _ACTIVE.phys_axis("tp")
    if ax is None or _ACTIVE.mesh.shape[ax] == 1:
        return None
    return ax


# ---------------------------------------------------------------------------
# Parameter partition specs (name-based rules)
# ---------------------------------------------------------------------------

# (regex on the path) -> logical axes per trailing dims.  Matching is
# last-rule-wins; dims are right-aligned (leading stack/period axes get
# None automatically).
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embedding$",              ("tp", "fsdp")),
    (r"unembed$",                ("fsdp", "tp")),
    (r"\b(wq|wk|wv)$",           ("fsdp", "tp")),
    (r"\bwo$",                   ("tp", "fsdp")),
    (r"\b(w_gate|w_up)$",        ("fsdp", "tp")),
    (r"\bw_down$",               ("tp", "fsdp")),
    (r"\brouter$",               (None, None)),
    # MoE experts (E, d, f) / (E, f, d): EP on experts + FSDP on d
    (r"moe.*\b(w_gate|w_up)$",   ("expert", "fsdp", None)),
    (r"moe.*\bw_down$",          ("expert", None, "fsdp")),
    # MLA
    (r"\bw_dq$",                 ("fsdp", None)),
    (r"\bw_uq$",                 (None, "tp")),
    (r"\bw_dkv$",                ("fsdp", None)),
    (r"\bw_kr$",                 (None, None)),
    (r"\b(w_uk|w_uv)$",          (None, "tp")),
    # mamba
    (r"\bw_in$",                 ("fsdp", "tp")),
    (r"\bconv_w$",               (None, "tp")),
    (r"\b(conv_b|d_skip|dt_bias)$", ("tp",)),
    (r"\ba_log$",                ("tp", None)),
    (r"\bw_bc$",                 ("tp", None)),
    (r"\bw_dt_down$",            ("tp", None)),
    (r"\bw_dt_up$",              (None, "tp")),
    # xlstm
    (r"\bw_if$",                 (None, None)),
    (r"\b(w_gates|r_gates)$",    ("fsdp", "tp")),
]

# leaves whose output columns concatenate `parts` equal parts: each part
# splits on its own along the column dim
_GROUPED: list[tuple[str, int]] = [
    (r"mixer/w_in$", 2),          # mamba [x | z]
    (r"mixer/w_up$", 2),          # mLSTM [xm | z], sLSTM [a | b]
    (r"mixer/w_gates$", 4),       # sLSTM [z, i, f, o]
]

# what the mesh Engine (and the dry run's serve cells) keep whole on every
# rank, although the reference's rules split them: the embedding (a row
# gather on a vocab-split table would cost a collective per forward);
# mamba's B/C and dt projections (the reference splits w_bc and w_dt_down
# by rows, which puts a float partial sum on the path: `models/mamba.py`
# computes them on the gathered row); the sLSTM's recurrent cell, whose
# every step needs the whole h (`models/xlstm.py`)
SERVE_WHOLE = (r"embedding$", r"\b(w_bc|w_dt_down|w_dt_up)$",
               r"\b(w_gates|r_gates)$")


def serve_whole(cfg) -> tuple[str, ...]:
    """`SERVE_WHOLE` and the sLSTM's `w_up` of `cfg`'s pattern: the rank
    computes the sLSTM FF's gelu(a)·b over the whole width, as the
    meshless block lays it out, and keeps its block of the product for the
    row-parallel `w_down` (`models/xlstm.py`).  The path names the
    pattern position, since the mLSTM's `w_up` has the same leaf name and
    splits."""
    return SERVE_WHOLE + tuple(
        rf"\bpos{i}/mixer/w_up$" for i, spec in enumerate(cfg.layer_pattern)
        if spec.startswith("slstm+"))


def spec_for(path_str: str, ndim: int) -> tuple:
    """Logical axes of the leaf at `path_str` (keys joined by "." or "/").
    A QuantizedTensor's values and scale inherit the parent weight's rule
    (right-aligned; non-divisible dims stay whole later)."""
    path_str = re.sub(r"[./](values|scale)$", "", path_str)
    chosen = None
    for pattern, axes in _PARAM_RULES:
        if re.search(pattern, path_str):
            chosen = axes
    if chosen is None:
        return (None,) * ndim
    pad = ndim - len(chosen)
    if pad < 0:        # param has fewer dims than rule (shouldn't happen)
        return (None,) * ndim
    return (None,) * pad + tuple(chosen)


def block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block i of `t` split n ways along `dim` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


@dataclasses.dataclass(frozen=True)
class Cut:
    """One cut of a leaf: `n` blocks along `dim` over mesh axis `axis`, of
    which this rank holds block `i`.  With `parts` > 1 the dim is the
    column dim of a `_GROUPED` leaf, `parts` equal parts laid end to end,
    and the rank holds block `i` of each part, in part order."""
    dim: int
    n: int
    i: int
    axis: str
    parts: int = 1

    def reorder(self, t: torch.Tensor) -> torch.Tensor:
        """The whole dim from its `n` ranks' blocks gathered in rank order
        (each rank's `parts` blocks end to end): the parts back in the
        leaf's order.  `t` itself when the dim is not parted."""
        if self.parts == 1:
            return t
        d, shape = self.dim, t.shape
        b = shape[d] // (self.n * self.parts)
        t = t.reshape(shape[:d] + (self.n, self.parts, b) + shape[d + 1:])
        return t.transpose(d, d + 1).reshape(shape)


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf of shape `whole` cut by each of `cuts` (at most one per dim,
    in dim order: ZeRO-3's `fsdp` cut over `data` and the `tp` cut over
    `model`), of which this rank holds one block a cut: a contiguous one,
    or along a parted dim (`Cut.parts`) its block of each part.  In the
    whole leaf's flat order the rank's values are runs of `run` elements,
    each ending at the last cut dim (or at the end of its part's block)
    and starting at a multiple of `run`."""
    whole: tuple
    cuts: tuple

    @property
    def axes(self) -> tuple:
        """The mesh axes the leaf is cut over, sorted by name."""
        return tuple(sorted({c.axis for c in self.cuts}))

    @property
    def local(self) -> tuple:
        out = list(self.whole)
        for c in self.cuts:
            out[c.dim] //= c.n
        return tuple(out)

    @property
    def run(self) -> int:
        last = self.cuts[-1]
        return self.local[last.dim] // last.parts * \
            math.prod(self.whole[last.dim + 1:])

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf `t` (a view where no dim is
        parted)."""
        for c in self.cuts:
            t = grouped_block(t, c.dim, c.n, c.i, c.parts)
        return t

    def join(self, t: torch.Tensor, gather) -> torch.Tensor:
        """The whole leaf from this rank's block `t`: `gather(t, cut)` joins
        the cut's blocks over its axis in rank order, cut by cut (a parted
        dim's parts then put back in order)."""
        for c in self.cuts:
            t = c.reorder(gather(t, c))
        return t

    def whole_index(self, j: torch.Tensor) -> torch.Tensor:
        """The whole leaf's flat index of this rank's flat positions j."""
        local, cut = self.local, {c.dim: c for c in self.cuts}
        out, stride = torch.zeros_like(j), 1
        for d in reversed(range(len(self.whole))):
            idx = j % local[d]
            j = torch.div(j, local[d], rounding_mode="floor")
            c = cut.get(d)
            if c is not None and c.parts == 1:
                idx = idx + c.i * local[d]
            elif c is not None:
                b = local[d] // c.parts          # one part's block
                part = torch.div(idx, b, rounding_mode="floor")
                idx = part * (c.n * b) + c.i * b + idx % b
            out += idx * stride
            stride *= self.whole[d]
        return out

    def grid(self, per: int) -> "Split":
        """The same cuts of the leaf's grid of `per`-element blocks in flat
        order, dims after the last cut folded into it (each run a whole
        number of blocks)."""
        last = self.cuts[-1].dim
        return Split(self.whole[:last] + (
            math.prod(self.whole[last:]) // per,), self.cuts)


def grouped_block(t: torch.Tensor, dim: int, n: int, i: int,
                  parts: int = 1) -> torch.Tensor:
    """Block i of each of `parts` equal parts of `t` along `dim`, split n
    ways, concatenated in part order (a view when parts == 1)."""
    if parts == 1:
        return block(t, dim, n, i)
    return torch.cat([block(p, dim, n, i) for p in t.chunk(parts, dim)],
                     dim)


def _stem(path: str) -> str:
    """The weight's path: a QuantizedTensor's values and scale take their
    parent's."""
    return re.sub(r"/(values|scale)$", "", path)


def _leaf_split(path: str, shape, ctx: ShardingCtx, whole) -> list:
    """[(dim, n, i, parts, axes)] of the mesh blocks the leaf at `path`
    takes along each dim its spec maps to mesh axes (`axes`: those of them
    with more than one rank); `parts` > 1 for the column dim of a
    `_GROUPED` leaf.  A leaf matching a regex of `whole` is not cut over
    the axes of the rules' `tp` and `expert` names (its `fsdp` dim still
    is, where the rules map `fsdp`).  A dim whose size the axes' product
    does not divide stays whole, as `to_sharding` leaves it, except the
    stored rows of a quantized row-parallel weight, which raise: that
    layer could not run on its slice of the input."""
    stem = _stem(path)
    kept = any(re.search(p, stem) for p in whole)
    mesh, out = ctx.mesh, []
    ndim = len(shape)
    for dim, name in enumerate(spec_for(path, ndim)):
        ax = ctx.rules.get(name) if name is not None else None
        if ax is None or (kept and name != "fsdp"):
            continue
        names = (ax,) if isinstance(ax, str) else tuple(ax)
        n, i = 1, 0
        for a in names:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
        if n == 1:
            continue
        axes = tuple(a for a in names if mesh.shape[a] > 1)
        if shape[dim] % n == 0:
            parts = next((g for p, g in _GROUPED if re.search(p, stem)), 1) \
                if dim == ndim - 1 else 1
            if shape[dim] % (n * parts):
                raise ValueError(
                    f"{stem}: {parts} column parts of {shape[dim] // parts} "
                    f"do not split {n} ways over {ax!r}")
            out.append((dim, n, i, parts, axes))
        elif name == "tp" and dim == ndim - 2 and path.endswith("/values"):
            raise ValueError(
                f"{stem}: its {shape[dim]} stored rows do not split {n} ways "
                f"over {ax!r} (a row-parallel weight splits on its stored "
                f"rows; with sub-byte values packed along K, K/{n} must be "
                f"a multiple of the values per byte)")
    return out


def shard_params(params: Any, ctx: ShardingCtx | None = None, *,
                 whole: tuple[str, ...] = ()) -> Any:
    """This rank's blocks of `params` under `ctx` (default: the active
    one): every leaf sliced along the dims its spec maps to mesh axes, a
    QuantizedTensor's values and scale alike, each part of a `_GROUPED`
    leaf on its own, then copied so the full tree can be freed.  Leaves
    whose path matches a regex of `whole` stay replicated.  Sub-byte
    weights packed along K split on the stored rows, so a row-parallel
    split needs K/n to be a multiple of the values per byte, else it
    raises ValueError naming the leaf."""
    ctx = ctx or _ACTIVE
    if ctx is None:
        raise ValueError("shard_params needs a sharding ctx")

    def place(path, leaf):
        out = leaf
        for dim, n, i, parts, _ in _leaf_split(path, leaf.shape, ctx,
                                                whole):
            out = grouped_block(out, dim, n, i, parts)
        return out if out is leaf else out.contiguous().clone()
    return tree_map_with_path(place, params)


def leaf_splits(params: Any, ctx: ShardingCtx, *,
                whole: tuple[str, ...] = ()) -> dict:
    """{path: Split or None} of every leaf of the whole tree `params` as
    `shard_params` places it (a `_GROUPED` leaf's column cut with its
    parts).  A leaf cut over two mesh axes at one dim raises: the
    training layouts keep one block a leaf and axis."""
    out = {}

    def note(path, leaf):
        found = _leaf_split(path, leaf.shape, ctx, whole)
        if any(len(axes) != 1 for _, _, _, _, axes in found):
            raise ValueError(f"{path}: split {found}; a training leaf splits "
                             f"into one block a mesh axis")
        out[path] = Split(tuple(leaf.shape), tuple(
            Cut(dim, n, i, axes[0], parts)
            for dim, n, i, parts, axes in found)) if found else None
        return leaf
    tree_map_with_path(note, params)
    return out


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """The model config one rank of a `tp_ways`-way model axis runs: the
    head and FF counts of `local_config`, and the recurrent mixers' widths
    (mamba's d_inner, the mLSTM's and sLSTM's projection widths) divided
    by `tp_ways`, so the mixers and their state builders size this rank's
    block."""
    tp_ways: int = 1

    @property
    def mamba_d_inner(self) -> int:
        return super().mamba_d_inner // self.tp_ways

    @property
    def mlstm_width(self) -> int:
        return super().mlstm_width // self.tp_ways

    @property
    def slstm_width(self) -> int:
        return super().slstm_width // self.tp_ways


def local_config(cfg, mesh: Mesh, axis: str = "model"):
    """The model config one rank of a `axis`-split mesh runs: H/n query
    heads and Hkv/n KV heads (contiguous, so rank r's `wo` rows are its
    own heads), d_ff/n of the dense FF, and a `RankConfig` with 1/n of the
    width of each recurrent mixer the pattern has; experts stay whole
    (they split over the EP route instead).  Raises ValueError naming the
    count or width that n does not divide."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return cfg
    mixers = {s.split("+")[0] for s in cfg.layer_pattern}
    dense_ff = any(s.endswith("+dense") for s in cfg.layer_pattern)
    checks = [("num_heads", cfg.num_heads),
              ("num_kv_heads", cfg.num_kv_heads)]
    if dense_ff:
        checks.append(("d_ff", cfg.d_ff))
    for mixer, width in (("mamba", "mamba_d_inner"),
                         ("mlstm", "mlstm_width"),
                         ("slstm", "slstm_width")):
        if mixer in mixers:
            checks.append((width, getattr(cfg, width)))
    for name, v in checks:
        if v % n:
            raise ValueError(f"{cfg.name}: {name}={v} is not divisible by "
                             f"the {n}-way '{axis}' axis")
    local = cfg.replace(num_heads=cfg.num_heads // n,
                        num_kv_heads=cfg.num_kv_heads // n,
                        d_ff=cfg.d_ff // n if dense_ff else cfg.d_ff,
                        moe_d_ff=cfg.expert_d_ff, head_dim=cfg.hd)
    return RankConfig(**{f.name: getattr(local, f.name)
                         for f in dataclasses.fields(local)}, tp_ways=n)
