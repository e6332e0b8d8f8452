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
The rules cover the layers the mesh Engine serves (attention, the dense
FF, MoE); the reference's MLA, mamba and xLSTM rules come with those
layers' mesh paths.

What differs from the reference: a mesh here is a grid of
`torch.distributed` ranks (processes), not of devices in one program.
`Mesh` holds this rank's coordinates and one process group per axis line
it sits on; `shard_params` slices each leaf to this rank's block (the
counterpart of `param_shardings` + `jax.device_put`).  `constrain` has no
counterpart: the port partitions explicitly — the model code calls the
collectives of `parallel.tp` / `parallel.ep` where the reference lets
GSPMD insert them.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any

import torch
import torch.distributed as dist

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
    its axis-line groups.  Every rank of the default group takes part in
    every `new_group` call, members or not, in the same order."""
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
            if coords is not None and coords[:a] + coords[a + 1:] == key:
                groups[axis] = g
    return Mesh(tuple(axes), tuple(sizes), coords, groups)


@dataclasses.dataclass
class ShardingCtx:
    mesh: Mesh
    rules: dict

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
    `comm.DryGroup`; an omitted `data` is 1.  Collectives over it take
    meta tensors and exchange nothing (`parallel.comm`)."""
    named = _parse(spec) if spec is not None else {}
    for name, val in named.items():
        if val < 1:
            raise ValueError(f"mesh axis {name}={val} must be >= 1")
    named.setdefault("data", 1)
    axes = tuple(a for a in _AXIS_ORDER if a in named)
    sizes = tuple(named[a] for a in axes)
    return Mesh(axes, sizes, (0,) * len(axes),
                {a: DryGroup(n) for a, n in zip(axes, sizes) if n > 1})


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
]


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


def _placed(t: torch.Tensor, dim: int, ctx: ShardingCtx, ax) -> torch.Tensor:
    """This rank's block of `t` along `dim` over the mesh axes `ax` (one
    name or a tuple, major first), or `t` when their size does not divide
    the dim (as `to_sharding` leaves it unsharded)."""
    mesh = ctx.mesh
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    n, i = 1, 0
    for a in names:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.index(a)
    if n == 1 or t.shape[dim] % n:
        return t
    return block(t, dim, n, i)


def shard_params(params: Any, ctx: ShardingCtx | None = None, *,
                 whole: tuple[str, ...] = ()) -> Any:
    """This rank's blocks of `params` under `ctx` (default: the active
    one): every leaf sliced along the dims its spec maps to mesh axes, a
    QuantizedTensor's values and scale alike, then copied so the full tree
    can be freed.  Leaves whose path matches a regex of `whole` stay
    replicated.  4-bit weights pair-packed along K split on the stored
    rows, so a row-parallel split needs an even K/n (else they stay
    whole, and the layer using them raises)."""
    ctx = ctx or _ACTIVE
    if ctx is None:
        raise ValueError("shard_params needs a sharding ctx")

    def place(path, leaf):
        if any(re.search(p, re.sub(r"/(values|scale)$", "", path))
               for p in whole):
            return leaf
        out = leaf
        for dim, name in enumerate(spec_for(path, leaf.ndim)):
            ax = ctx.rules.get(name) if name is not None else None
            if ax is not None:
                out = _placed(out, dim, ctx, ax)
        return out if out is leaf else out.contiguous().clone()
    return tree_map_with_path(place, params)


def local_config(cfg, mesh: Mesh, axis: str = "model"):
    """The model config one rank of a `axis`-split mesh runs: H/n query
    heads and Hkv/n KV heads (contiguous, so rank r's `wo` rows are its
    own heads) and d_ff/n of the dense FF; experts stay whole (they split
    over the EP route instead).  Raises ValueError when n does not divide
    them."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return cfg
    dense_ff = any(s.endswith("+dense") for s in cfg.layer_pattern)
    for name, v in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads)) + \
            ((("d_ff", cfg.d_ff),) if dense_ff else ()):
        if v % n:
            raise ValueError(f"{cfg.name}: {name}={v} is not divisible by "
                             f"the {n}-way '{axis}' axis")
    return cfg.replace(num_heads=cfg.num_heads // n,
                       num_kv_heads=cfg.num_kv_heads // n,
                       d_ff=cfg.d_ff // n if dense_ff else cfg.d_ff,
                       moe_d_ff=cfg.expert_d_ff, head_dim=cfg.hd)
