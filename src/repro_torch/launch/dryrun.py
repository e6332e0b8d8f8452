"""Dry run of the port on one H100: every (arch x shape) cell counted on
the `meta` device (port of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k --out /tmp/dryrun [--variant q8] \\
        [--mesh model=2] [--probe auto|on|off]

The reference lowers and compiles each cell's step on a 256- or 512-chip
v5e mesh and reads memory, FLOPs, bytes and collective traffic from XLA.
The port runs eagerly, so it runs its own step functions (the Trainer's
`train_step`, `model.prefill`, `model.decode_step` over dense caches) on
meta tensors under `launch.counting.Counter`, which counts each aten op's
FLOPs and bytes and the live bytes, and writes one JSON record per cell
with the reference's keys where they mean something here (the bytes and
FLOPs keys under the port's own names: `bytes_per_dev`, `flops_per_dev`),
roofline terms over the card's data-sheet peaks (`launch.device`), and the
card's memory beside the predicted peak.  Nothing is allocated; no card is
needed.

Counting.  `--probe on` counts two and three periods of the layer stack
and scales the difference to `n_periods` (each count is affine in the
number of periods: the stack repeats, the embedding, loss and unembed do
not), as the reference's unrolled cost probe corrects its scanned module;
`off` runs the whole stack; `auto` (default) scales only the prefills of
the stacks that scan step by step (jamba's mamba, xlstm's mLSTM and
sLSTM: millions of meta ops at S = 32768) and counts every training step
whole, whose peak the scaling understates (see `count`).  The record says
which (`cost_probe`).  The port's scans run in
Python loops, so the sLSTM recurrence's R·h FLOPs are counted step by
step; the reference's analytic `_slstm_scan_correction` is kept as a
check beside them (`slstm_rh_flops`).

What differs from the reference:
- eager PyTorch keeps every activation for the backward: the port has no
  remat, so its `baseline` train cell is the reference's `no_remat`; the
  `no_remat` names are refused as such;
- `cache_seq*` shard the KV cache along the sequence, a layout the port
  does not have: refused with the reason;
- `--mesh` takes the port's specs for ranks sharing the card
  (`model=2`, `data=2`, ...), built with no processes
  (`sharding.dry_mesh`); its collectives return meta results and count
  their result bytes by kind.  Prefill and decode run the mesh Engine's
  rules, weights and mixers (serve rules, `shard_params` with
  `serve_whole`, `local_config`: every layer kind but xattn);
  training runs the Trainer's own layout (`trainer.TrainLayout`: train
  rules, each rank's blocks of the params and AdamW state; a `data` axis
  is ZeRO-3, every leaf the rules cut on its `fsdp` dim held 1/n and
  gathered per use), so the forward's gathers, the backward's re-gathers
  and reduce-scatters and the tensor-parallel collectives (every layer
  kind's, the mixers' own included) are counted; a training record says
  which placement it counted (`placement`); serving an xattn arch under
  a mesh raises the port's own error (`status: error`), as the Engine
  refuses such an arch.  The
  256/512-chip production meshes mean nothing on one card and are not
  taken;
- ranks share one card, so the roofline terms are the card's: every
  rank's FLOPs and bytes over its peaks.  Host-staged gloo has no
  data-sheet rate: `collective_s` is null, `dominant` is compute or memory.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import archs, get_config
from repro_torch.launch import analysis, specs
from repro_torch.launch import device as dev
from repro_torch.launch.counting import Counter
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.runtime import trainer
from repro_torch.tree import tree_items, tree_leaves

OPT_CFG = adamw.AdamWConfig()
ONE_CARD = "card"
COLLECTIVE_NOTE = ("ranks share one card and collect over host-staged gloo, "
                   "which has no data-sheet rate")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg, opt_cfg: adamw.AdamWConfig = OPT_CFG,
                    mark=lambda: None, layout=None):
    """The Trainer's step (`trainer.TrainLayout.step`, which
    `Trainer.run_step` runs), with `mark()` called between its phases:
    `model.loss_fn`, its backward with the data-parallel mean,
    `adamw.apply` with the gradients released.  `layout` (default: `cfg`
    on one card) holds the mesh and the parameters' splits, which
    `specs.state_specs` notes on it."""
    layout = layout or trainer.TrainLayout(cfg)

    def train_step(params, opt_state, batch):
        return params, opt_state, layout.step(params, opt_state, batch,
                                              opt_cfg, mark)
    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch, caches):
        return M.prefill(params, batch, cfg, caches)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, tokens, caches, pos):
        return M.decode_step(params, tokens, cfg, caches, pos)
    return decode_step


def slstm_scan_correction(cfg, info) -> float:
    """The reference's `_slstm_scan_correction`: the R·h FLOPs of the
    (S - 1) sLSTM steps its probe does not count (x4 for train: forward,
    remat, two backward products).  The port counts every step; this is
    its check."""
    n_slstm = sum(s.startswith("slstm") for s in cfg.layer_pattern) \
        * cfg.n_periods
    if not n_slstm or info["kind"] == "decode" or info["seq"] <= 1:
        return 0.0
    per_step = 2 * info["batch"] * cfg.d_model * 4 * cfg.d_model
    mult = 4 if info["kind"] == "train" else 1
    return float(n_slstm) * (info["seq"] - 1) * per_step * mult


def slstm_rh_flops(cfg, mm_flops, batch: int) -> float:
    """The counted FLOPs of the sLSTM's f32 R·h products: (B, d) x (d, 4d)
    forward, (B, 4d) x (4d, d) and (d, B) x (B, 4d) backward.  Read by
    their shapes, so only where no other f32 product shares them: prefill
    and train (at decode the bf16 projections run at M = B too)."""
    d, B = cfg.d_model, batch
    shapes = {((B, d), (d, 4 * d)), ((B, 4 * d), (4 * d, d)),
              ((d, B), (B, 4 * d))}
    return float(sum(n for key, n in mm_flops.items()
                     if key[0] == "f32" and key[1:] in shapes))


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

def _storages(tree) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for _, t in tree_items(tree)}


def count_step(cfg, info: dict, quant_bits: int = 0, mesh=None) -> dict:
    """Run one step of `cfg` at `info` ({"batch", "seq", "kind"}) on meta
    tensors for rank 0 of `mesh` (None: one card, no mesh) and return its
    raw counts.  Prefill and decode under a mesh run with the serve rules
    active, as the mesh Engine does."""
    kind, S = info["kind"], info["seq"]
    ctx = layout = None
    counter = Counter()
    if kind == "train":
        layout = trainer.TrainLayout(cfg, mesh)
        step = make_train_step(cfg, OPT_CFG, mark=counter.mark,
                               layout=layout)
    elif mesh is not None:
        xattn = [s for s in cfg.layer_pattern if s.startswith("xattn+")]
        if xattn:
            # the Engine refuses such an arch (it feeds no vision inputs),
            # so the mesh path has no split for its layers
            raise NotImplementedError(
                f"{cfg.name}: a {xattn[0]!r} layer under a mesh is not "
                f"served (the Engine feeds no vision inputs)")
        ctx = sharding.activate(mesh, sharding.serve_rules(
            "pod" in mesh.axis_names))
    try:
        rcfg = specs.rank_config(cfg, mesh) if ctx is not None else cfg
        batch = specs.batch_specs(cfg, info)
        if kind == "train":
            params, opt = specs.state_specs(cfg, OPT_CFG, layout)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            args = (params, opt, batch)
        else:
            params = specs.rank_params(specs.param_specs(cfg, quant_bits),
                                       ctx, cfg)
            batch = specs.rank_batch(batch, mesh)
            b_rank = next(iter(batch.values())).shape[0]
            if ctx is not None:
                # the mesh Engine's slot split: MoE gathers over `data`
                ctx.split_batch = b_rank < info["batch"]
            caches = specs.cache_specs(rcfg, b_rank, S)
            if kind == "prefill":
                step, args = make_prefill_step(rcfg), (params, batch, caches)
            else:
                pos = torch.empty((b_rank,), dtype=torch.int32,
                                  device="meta")
                step = make_decode_step(rcfg)
                args = (params, batch["tokens"], caches, pos)
        args_bytes = counter.track(args)
        arg_st = _storages(args)
        comm.stats.reset()
        with counter:
            out = step(*args)
        out_st = _storages(out)
        return {
            "flops": dict(counter.flops), "bytes": counter.bytes,
            "ops": counter.ops, "peaks": counter.peaks,
            "peaks_rounded": counter.peaks_rounded, "args": args_bytes,
            "output": sum(out_st.values()),
            "alias": sum(n for k, n in out_st.items() if k in arg_st),
            "kernel_calls": counter.kernel_calls,
            "coll_calls": dict(comm.stats.kind_calls),
            "coll_bytes": dict(comm.stats.kind_bytes),
            "mm_flops": dict(counter.mm_flops)}
    finally:
        if ctx is not None:
            sharding.deactivate()


def _affine(c1, c2, n):
    """c1 + (n - 1) (c2 - c1), leaf by leaf over dicts and lists of
    counts: the n-th term of the line through c1 and c2."""
    if isinstance(c1, dict):
        return {k: _affine(c1.get(k, 0), c2.get(k, 0), n)
                for k in set(c1) | set(c2)}
    if isinstance(c1, list):
        return [_affine(a, b, n) for a, b in zip(c1, c2, strict=True)]
    return c1 + (n - 1) * (c2 - c1)


def _peaks(c: dict) -> dict:
    """`c` with its peak: the largest of its phases' peaks."""
    return {**c, "peak": max(c["peaks"]),
            "peak_rounded": max(c["peaks_rounded"])}


PROBES = (2, 3)        # periods of the two counted stacks


def count(cfg, info: dict, quant_bits: int = 0, mesh=None,
          probe: str = "auto") -> tuple[dict, str]:
    """`count_step` of the whole stack, or of two and three periods scaled
    to `cfg.n_periods` where the stack has more than three: probe "on", or
    "auto" for a prefill of a stack that scans step by step (mamba, mLSTM,
    sLSTM over its positions).  Every count is affine in the periods.  A
    peak is a maximum: each phase's is scaled on its own line (a training
    step's forward, backward and update grow at different rates) and the
    step's is their largest; two and three periods, because a lone
    period's layers follow the embedding, not another period.  A scaled
    training peak still falls short where a transient that grows faster
    with depth takes over deeper in: granite-8b's training step (B=4,
    S=64) peaks at 61.87 GB counted whole, 58.60 GB scaled (autograd
    stacks each stacked weight's gradient while its periods' parts are
    live), so "auto" counts training whole and `record` marks a scaled
    training peak as a lower bound.  Returns (counts, "per_period" |
    "whole_stack")."""
    n = cfg.n_periods
    scans = tf.is_recurrent(cfg) and info["kind"] == "prefill"
    if n <= PROBES[1] or probe == "off" or (probe == "auto" and not scans):
        return _peaks(count_step(cfg, info, quant_bits, mesh)), "whole_stack"
    period = len(cfg.layer_pattern)
    lo, hi = (count_step(cfg.replace(num_layers=k * period), info,
                         quant_bits, mesh) for k in PROBES)
    return _peaks(_affine(lo, hi, n - PROBES[0] + 1)), "per_period"


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def model_flops(cfg, info) -> float:
    """Useful-work FLOPs of the whole step, global: 6 (train) or 2 x active
    params x tokens."""
    n_active = cfg.active_param_count()
    if info["kind"] == "train":
        return 6 * n_active * info["batch"] * info["seq"]
    if info["kind"] == "prefill":
        return 2 * n_active * info["batch"] * info["seq"]
    return 2 * n_active * info["batch"]


def roofline(c: dict, ranks: int, card: dev.Card, model_flops_global: float
             ) -> dict:
    """The card's roofline terms of counts `c` of one rank, all `ranks`
    ranks on the one card."""
    compute = sum(ranks * n / card.peak(k) for k, n in c["flops"].items())
    memory = ranks * c["bytes"] / card.hbm_bytes_per_s
    flops_global = ranks * sum(c["flops"].values())
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": None, "collective_note": COLLECTIVE_NOTE,
            "dominant": "compute" if compute >= memory else "memory",
            "model_flops_global": model_flops_global,
            "flops_global": flops_global,
            "useful_ratio": model_flops_global / max(flops_global, 1.0),
            "roofline_fraction": compute / max(compute, memory, 1e-30)}


def record(cfg, info: dict, c: dict, counted: str, ranks: int,
           card: dev.Card, rank_batch: int | None = None) -> dict:
    """The record's counters and roofline for counts `c` of one rank, which
    runs `rank_batch` rows (default: the whole batch).  A training peak
    counted per period is a lower bound (`count`): such a record says so
    and gives no `fits_card`."""
    peak = c["peak"]
    memory = {
        "args_bytes_per_dev": c["args"],
        "output_bytes_per_dev": c["output"],
        "temp_bytes_per_dev": peak - c["args"] - c["output"] + c["alias"],
        "alias_bytes_per_dev": c["alias"],
        "peak_est_bytes_per_dev": peak,
        "peak_rounded_bytes_per_dev": c["peak_rounded"],
        "card_peak_bytes": ranks * peak,
        "card_memory_bytes": card.memory_bytes}
    if counted == "per_period" and info["kind"] == "train":
        memory["peak_is_lower_bound"] = True
    else:
        memory["fits_card"] = ranks * c["peak_rounded"] <= card.memory_bytes
    rec = {
        "cost_probe": counted, "n_periods": cfg.n_periods,
        "batch_per_dev": rank_batch or info["batch"],
        "card": {"name": card.name, "power_limit_w": card.power_limit_w},
        "memory": memory,
        "flops_per_dev": float(sum(c["flops"].values())),
        "flops_by_class_per_dev": {k: float(v) for k, v in
                                   c["flops"].items() if v},
        "bytes_per_dev": float(c["bytes"]),
        "aten_ops_per_dev": c["ops"],
        "kernel_calls_per_dev": {"bramac_matmul": c["kernel_calls"]},
        "collective_calls_per_dev": c["coll_calls"],
        "collective_bytes_per_dev": c["coll_bytes"],
        "collective_bytes_total_per_dev": sum(c["coll_bytes"].values()),
        "roofline": roofline(c, ranks, card, model_flops(cfg, info))}
    if info["kind"] != "decode" and any(s.startswith("slstm")
                                        for s in cfg.layer_pattern):
        rec["slstm_rh_flops"] = {
            "counted": slstm_rh_flops(cfg, c["mm_flops"],
                                      rank_batch or info["batch"]),
            "reference_correction": slstm_scan_correction(cfg, info)}
    return rec


def _refused(reason: str):
    """A VARIANTS transform that refuses the variant with `reason`."""
    def refuse(cfg):
        raise NotImplementedError(reason)
    return refuse


_CACHE_SEQ = _refused(
    "cache_seq variants shard the KV cache along the sequence; the port "
    "has no such KV layout (its caches are dense or paged per slot)")
_NO_REMAT = _refused(
    "the port has no remat (eager PyTorch keeps every activation): its "
    "baseline and moe_sort train cells are the reference's no_remat ones")

VARIANTS = {
    # name: (cfg transform, rules: None | "serve", serve quant bits)
    # "baseline" pins the cumsum dispatch, as the reference's does
    "baseline": (lambda c: c.replace(moe_dispatch="cumsum"), None, 0),
    "moe_sort": (lambda c: c.replace(moe_dispatch="sort"), None, 0),
    "serve_tp": (lambda c: c, "serve", 0),
    "serve_tp_q8": (lambda c: c, "serve", 8),
    "serve_tp_q4": (lambda c: c, "serve", 4),
    "q8": (lambda c: c, None, 8),
    "q4": (lambda c: c, None, 4),
    "cache_seq": (_CACHE_SEQ, None, 0),
    "cache_seq_q8": (_CACHE_SEQ, None, 8),
    "cache_seq_q4": (_CACHE_SEQ, None, 4),
    "cache_seq_q8_kv8": (_CACHE_SEQ, None, 8),
    "serve_cache_seq_q4": (_CACHE_SEQ, "serve", 4),
    "no_remat": (_NO_REMAT, None, 0),
    "moe_sort_no_remat": (_NO_REMAT, None, 0),
}


def mesh_tag(spec: str | None) -> str:
    return ONE_CARD if spec in (None, ONE_CARD) else \
        str(spec).replace(",", "_")


def predict(cfg, info: dict, quant_bits: int = 0, mesh: str | None = None,
            probe: str = "auto") -> dict:
    """The record of one step of `cfg` at `info` ({"kind", "batch",
    "seq"}): counts, memory and roofline on the present card (the H100's
    data sheet without one), for one card (mesh None) or rank 0 of a dry
    mesh spec, and the seconds the counting took."""
    m = None if mesh in (None, ONE_CARD) else sharding.dry_mesh(mesh)
    sizes = {} if m is None else m.shape
    ranks = math.prod(sizes.values())
    lo, hi = sharding.data_rows(info["batch"], m)
    b_rank = hi - lo
    t0 = time.perf_counter()
    c, counted = count(cfg, info, quant_bits, m, probe)
    rec = {"mesh": mesh_tag(mesh), "ranks": ranks,
           "count_s": round(time.perf_counter() - t0, 2)}
    if info["kind"] == "train":
        rec["placement"] = placement(sizes)
    rec.update(record(cfg, info, c, counted, ranks, dev.card(), b_rank))
    return rec


def placement(sizes: dict) -> str:
    """The training placement a mesh of `sizes` counts, in words."""
    parts = []
    if sizes.get("data", 1) > 1:
        parts.append(f"ZeRO-3 over data={sizes['data']} (params, int8 m "
                     f"and v cut on the fsdp dims, gathered per use, "
                     f"gradients reduce-scattered)")
    if sizes.get("model", 1) > 1:
        parts.append(f"tensor-parallel over model={sizes['model']}")
    return "; ".join(parts) or "whole state on one card"


def run_cell(arch: str, shape: str, variant: str = "baseline",
             mesh: str | None = None, probe: str = "auto") -> dict:
    """Count one cell: `arch` at the reference's `shape`, a VARIANTS
    entry, on one card (mesh None) or rank 0 of a dry mesh spec.  The
    serve variants' rules are the mesh Engine's own, so they change
    nothing the port runs; quant bits serve with quantized weights
    (prefill and decode only, as the reference's)."""
    transform, _, qbits = VARIANTS[variant]
    cfg = transform(get_config(arch))
    info = archs.SHAPES[shape]
    qbits = qbits if info["kind"] != "train" else 0
    rec = {"arch": arch, "shape": shape, "variant": variant, "status": "ok"}
    rec.update(predict(cfg, info, qbits, mesh, probe))
    model_par = 1 if mesh in (None, ONE_CARD) else \
        sharding.dry_mesh(mesh).shape.get("model", 1)
    floor = analysis.min_bytes_per_dev(
        arch, shape, chips=rec["ranks"], model_par=model_par,
        weight_bytes=qbits / 8 if qbits else analysis.BYTES)
    rec["min_bytes_per_dev"] = floor
    rec["roofline"]["min_memory_s"] = \
        rec["ranks"] * floor / dev.card().hbm_bytes_per_s
    return rec


def _cell(arch, shape, variant, mesh, probe, path) -> str:
    """Count one cell into its record at `path`; the line that reports it.
    A cell's failure is its record, as the reference's dry run keeps one."""
    head = {"arch": arch, "shape": shape, "variant": variant,
            "mesh": mesh_tag(mesh)}
    try:
        rec = run_cell(arch, shape, variant, mesh, probe)
    except Exception as e:  # noqa: BLE001
        rec = {**head, "status": "error", "error": repr(e),
               "trace": traceback.format_exc()[-4000:]}
    _write(path, rec)
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        peak = rec["memory"]["peak_est_bytes_per_dev"] / 1e9
        extra = (f" dominant={r['dominant']}"
                 f" frac={r['roofline_fraction']:.2f}"
                 f" peak={peak:.1f}GB count={rec['count_s']}s")
    return f"[done] {os.path.basename(path)[:-5]}: {rec['status']}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=ONE_CARD,
                    help="'card' (one card, no ranks) or a mesh spec of "
                         "ranks sharing it: model=2, data=2, ...")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--probe", default="auto", choices=["auto", "on", "off"],
                    help="per-period counting: auto = the prefills of the "
                         "stacks that scan step by step; on = every stack; "
                         "off = none")
    args = ap.parse_args(argv)

    arch_list = list(archs.FULL) if args.arch == "all" else [args.arch]
    shape_list = list(archs.SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    for arch in arch_list:
        for shape in shape_list:
            tag = f"{arch}__{shape}__{mesh_tag(args.mesh)}"
            if args.variant != "baseline":
                tag += f"__{args.variant}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip existing] {tag}")
            elif not archs.shape_applicable(arch, shape):
                _write(path, {"arch": arch, "shape": shape,
                              "variant": args.variant,
                              "mesh": mesh_tag(args.mesh),
                              "status": "skipped",
                              "reason": "long_500k needs sub-quadratic "
                                        "mixing; this arch is pure "
                                        "full-attention"})
                print(f"[skip by design] {tag}")
            else:
                print(f"[run] {tag}", flush=True)
                print(_cell(arch, shape, args.variant, args.mesh, args.probe,
                            path), flush=True)


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
