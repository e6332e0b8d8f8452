"""Rank-side bodies of the port's parallel tests (`tests/test_torch_parallel_
*.py`, `tests/test_torch_dp_trainer.py`, `tests/test_torch_tp_trainer.py`,
`tests/test_torch_zero_trainer.py`, `tests/test_torch_ep_trainer.py`,
`tests/test_torch_tp_mixers_trainer.py`).

Each test file spawns its ranks once (`repro_torch.parallel.comm.spawn`,
gloo on the CPU) with one of the functions below, which runs every case's
rank side and returns its results; the parametrised tests then hold them
against the JAX package's single-device functions in the test process.
This module imports torch and the port only, so a rank never loads JAX.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.parallel import sharding as shd
from repro_torch.tree import tree_items, tree_map


def _np(t):
    return t.detach().cpu().numpy()


def _errors(fn) -> str:
    """The ValueError message `fn()` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _meshes():
    """model=4 (4-way) and data=2,model=2 (2-way model inside 2 replicas)
    over 4 ranks; every rank builds both, in the same order."""
    return {4: shd.build_mesh("model=4"), 2: shd.build_mesh("data=2,model=2")}


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------

def tp_rank(rank, world, device, cases, dense_cases):
    """`tp_quant_matmul` on every (n, bits_a, bits_w, partition) case, the
    active-rule case, the divisibility errors and `row_parallel_dense`."""
    from repro_torch.models import layers
    from repro_torch.parallel import tp

    meshes = _meshes()
    out = {"matmul": {}, "dense": {}}
    for key, (xq, wq, xs, ws) in cases.items():
        bits_a, bits_w = key
        for n, mesh in meshes.items():
            for part in ("k", "n"):
                y = tp.tp_quant_matmul(xq, wq, xs, ws, mesh=mesh,
                                       bits_a=bits_a, bits_w=bits_w,
                                       partition=part)
                out["matmul"][(n, bits_a, bits_w, part)] = (str(y.dtype),
                                                            _np(y))
    # with a ctx active, tp resolves the axis from the `tp` rule
    xq, wq, _, _ = cases[(8, 8)]
    one = torch.ones((1, 1))
    shd.activate(meshes[2])
    try:
        out["rule"] = _np(tp.tp_quant_matmul(xq, wq, one, one,
                                             mesh=meshes[2], bits_a=8,
                                             bits_w=8))
    finally:
        shd.deactivate()
    x, w = torch.zeros((4, 10), dtype=torch.int8), \
        torch.zeros((10, 8), dtype=torch.int8)
    out["div_k"] = _errors(lambda: tp.tp_quant_matmul(
        x, w, one, one, mesh=meshes[4], bits_a=8, bits_w=8))
    out["div_n"] = _errors(lambda: tp.tp_quant_matmul(
        x, w[:, :6], one, one, mesh=meshes[4], bits_a=8, bits_w=8,
        partition="n"))
    # the model's row-parallel linear on this rank's K-slice and rows
    for key, (x, qw, qcfg) in dense_cases.items():
        for n, mesh in meshes.items():
            ctx = shd.activate(mesh, shd.serve_rules(False))
            try:
                w = shd.shard_params({"mlp": {"w_down": qw}}, ctx)
                i = mesh.index("model")
                xs = x[:, i * x.shape[1] // n:(i + 1) * x.shape[1] // n]
                y = layers.dense_row(xs, w["mlp"]["w_down"], qcfg)
            finally:
                shd.deactivate()
            out["dense"][(key, n)] = _np(y)
    return out


# ---------------------------------------------------------------------------
# expert parallel
# ---------------------------------------------------------------------------

def ep_rank(rank, world, device, einsum_cases, moe_cases, cfg):
    """The expert einsum (e, d, with a dp axis), `ep_moe` in both
    dispatches, moe() routed through EP under a ctx."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import ep

    meshes = _meshes()
    out = {"einsum": {}, "moe": {}}
    for bits, (x, qw) in einsum_cases.items():
        for n, mesh in meshes.items():
            for part in ("e", "d"):
                y = ep.ep_quant_einsum_edf(x, qw, mesh=mesh, partition=part)
                out["einsum"][(bits, n, part, None)] = _np(y)
        for part in ("e", "d"):
            y = ep.ep_quant_einsum_edf(x, qw, mesh=meshes[2], partition=part,
                                       dp_axis="data")
            out["einsum"][(bits, 2, part, "data")] = _np(y)
    x, qw = einsum_cases[8]
    out["div"] = _errors(lambda: ep.ep_quant_einsum_edf(
        x[:6], qw.map(lambda a: a[:6]), mesh=meshes[4], partition="e"))
    x = moe_cases["x"]
    for name, p in moe_cases["params"].items():
        for n, mesh in meshes.items():
            for cf in (cfg.num_experts / cfg.experts_per_token, 1.0):
                for disp in ("global", "per_source"):
                    y, aux, keep = ep.ep_moe(p, x, cfg, mesh=mesh,
                                             capacity_factor=cf,
                                             dispatch=disp,
                                             return_drops=True)
                    out["moe"][(name, n, cf, disp)] = (
                        _np(y), float(aux), _np(keep))
    # with a ctx active, moe()'s quantized expert compute routes through EP
    shd.activate(meshes[2])
    try:
        p = moe_cases["params"][8]
        out["route"] = _np(tmoe.moe(p, x, cfg)[0])
        out["route_ps"] = _np(tmoe.moe(p, x, cfg, capacity_factor=1.0,
                                       dispatch="per_source")[0])
    finally:
        shd.deactivate()
    return out


# ---------------------------------------------------------------------------
# the mesh Engine
# ---------------------------------------------------------------------------

def serve_streams(cfg, params, waves, device, **kw):
    """Greedy streams of `waves` (lists of (prompt, new tokens)) through a
    fresh Engine; each wave submitted together, the next after it drains."""
    from repro_torch.runtime.serve import Engine
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", 32)
    outs = []
    with Engine(cfg, params, device=device, **kw) as eng:
        for wave in waves:
            reqs = [eng.submit(p, n) for p, n in wave]
            eng.run()
            outs += [list(r.out_tokens) for r in reqs]
    return outs


def engine_snapshot(eng, results) -> dict:
    """What the host of an Engine (the port's or the reference's) decided:
    results without their times, telemetry and counters."""
    snap = {"results": [(r.uid, tuple(int(t) for t in r.tokens),
                         r.finish_reason, r.prefill_tokens, r.drafted_tokens,
                         r.accepted_tokens, r.pages_shared) for r in results],
            "prefix": eng.prefix_stats(), "n_syncs": eng.n_syncs,
            "n_ticks": eng.n_ticks, "n_admit_calls": eng.n_admit_calls,
            "kv_bytes_read": eng.kv_bytes_read}
    spec = eng.spec_stats()
    snap["spec"] = (spec["drafted"], spec["accepted"])
    if eng.kv_layout == "paged":
        snap.update(high_water=eng.pages_high_water,
                    shared_high_water=eng.pages_shared_high_water,
                    in_use=eng.pages_in_use)
    return snap


def pool_digest(eng) -> str | None:
    """blake2b of every page-pool leaf's bytes (None under the dense
    layout, which has no pool)."""
    import hashlib

    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    if eng.kv_layout != "paged":
        return None
    h = hashlib.blake2b(digest_size=16)
    for leaf, is_pool in zip(tree_leaves(eng.caches),
                             tree_leaves(M.cache_pool_flags(eng.cfg))):
        if is_pool:
            h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def watched():
    """Inside the block: the batch rows of every `model.forward` (the
    serving model's and the drafter's) and the MoE assignments each
    capacity dispatch dropped, collected in the dict it yields."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.parallel import ep

    seen = {"rows": set(), "drops": 0}
    forward, dispatch = M.forward, moe.dispatch_buffer

    def rows_of(params, batch, *a, **k):
        seen["rows"].add(int(batch["tokens"].shape[0]))
        return forward(params, batch, *a, **k)

    def drops_of(E, C, a, pos_c, keep, xk):
        seen["drops"] += int((~keep).sum())
        return dispatch(E, C, a, pos_c, keep, xk)

    M.forward, moe.dispatch_buffer, ep.dispatch_buffer = \
        rows_of, drops_of, drops_of
    try:
        yield seen
    finally:
        M.forward, moe.dispatch_buffer, ep.dispatch_buffer = \
            forward, dispatch, dispatch


def split_serve(cfg, params, waves, device, **kw) -> dict:
    """`waves` through a fresh Engine (each wave submitted together, the
    next after it drains) with every invariant check on: the streams, the
    host's snapshot, the rows each forward ran, the MoE drops, this
    rank's `rank_slots` and its pool's digest."""
    from repro_torch.runtime.serve import Engine

    t0 = time.perf_counter()
    results, streams = [], []
    with watched() as seen, Engine(cfg, params, device=device,
                                   check_invariants=True, **kw) as eng:
        for wave in waves:
            reqs = [eng.submit(p, n) for p, n in wave]
            results += eng.run()
            streams += [list(r.out_tokens) for r in reqs]
        return {"streams": streams, "snap": engine_snapshot(eng, results),
                "rows": sorted(seen["rows"]), "drops": seen["drops"],
                "rank_slots": eng.rank_slots, "digest": pool_digest(eng),
                "checks": eng.n_invariant_checks,
                "coords": {} if eng.mesh is None else
                dict(zip(eng.mesh.axis_names, eng.mesh.coords)),
                "seconds": time.perf_counter() - t0}


def engine_rank(rank, world, device, runs, split_runs=None):
    """Each run (cfg, params, waves, Engine kwargs) under its mesh; each
    data-split run (cfg, params, waves, Engine kwargs, mesh spec) through
    `split_serve`; and the refusals that need a mesh of more than one
    rank: ctx released after a construction that raises, non-dividing
    heads."""
    from repro_torch.runtime.serve import Engine

    out = {}
    for name, (cfg, params, waves, kw) in runs.items():
        out[name] = serve_streams(cfg, params, waves, device, **kw)
        out[name + "_ctx_after"] = shd.active() is not None
    meshes = {"data=2,model=2": shd.build_mesh("data=2,model=2"),
              "data=4": shd.build_mesh("data=4")}
    out["split"] = {
        name: split_serve(cfg, params, waves, device, mesh=meshes[spec],
                          **kw)
        for name, (cfg, params, waves, kw, spec) in (split_runs
                                                     or {}).items()}
    cfg, params, _, _ = runs["granite"]
    eng = Engine(cfg, params, num_slots=1, max_seq=16, mesh="model=2",
                 decode_kernel=True, device=device)
    out["ctx_open"] = shd.active() is not None
    out["heads"] = (eng.cfg.num_heads, eng.cfg.num_kv_heads, eng.cfg.d_ff)
    out["decode_kernel"] = eng.decode_kernel
    eng.close()
    eng.close()
    out["ctx_closed"] = shd.active() is None
    # smoke granite has 2 KV heads: a 4-way model axis cannot split them
    out["heads_error"] = _errors(lambda: Engine(
        cfg, params, num_slots=1, max_seq=16, mesh="model=4", device=device))
    out["ctx_after_error"] = shd.active() is None
    return out


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

def _toy_loss(target):
    def loss_fn(p, batch):
        return torch.mean((batch @ p["w"] - batch @ target) ** 2)
    return loss_fn


def dp_rank(rank, world, device, toy, trainer_case):
    """One compressed and one exact DP step of the reference's toy
    problem, 200 steps of each, and the data-parallel Trainer."""
    from repro_torch.runtime import dp_trainer as dp

    mesh = shd.build_mesh(data=world)
    params, target, batch = toy
    loss_fn = _toy_loss(target)
    step = dp.make_dp_train_step(loss_fn, mesh, compress=True)
    exact = dp.make_dp_train_step(loss_fn, mesh, compress=False)
    err = dp.init_error_feedback(params, mesh)
    g1, err1, l1 = step(params, err, batch)
    g0, _, l0 = exact(params, err, batch)
    out = {"g1": _np(g1["w"]), "err1": _np(err1["w"]), "l1": float(l1),
           "g0": _np(g0["w"]), "l0": float(l0), "finals": []}
    for st in (step, exact):
        p = {"w": params["w"].clone()}
        e = dp.init_error_feedback(params, mesh)
        for _ in range(200):
            g, e, loss = st(p, e, batch)
            p = {"w": p["w"] - 0.05 * g["w"]}
        out["finals"].append(float(loss))
    out["trainer"] = trainer_rank(mesh, *trainer_case)
    return out


def trainer_rank(mesh, cfg, params, batches, ckpt_dir):
    """The Trainer on `mesh`: a restore of the checkpoint in `ckpt_dir`,
    then one step per batch; returns the losses and the final weights."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=1000,
                         async_ckpt=False, opt=adamw.AdamWConfig(lr=1e-3))
    trainer = Trainer(cfg, tcfg, params, mesh=mesh)
    restored = trainer.restore_latest()
    losses = [trainer.run_step(b)["loss"] for b in batches]
    return {"restored": restored, "losses": losses,
            "params": {k.partition("/")[2]: _np(v) for k, v in tree_items(
                trainer.layout.gather({"params": trainer.params}))}}


# ---------------------------------------------------------------------------
# tensor-parallel training
# ---------------------------------------------------------------------------

def _whole_np(layout, tree):
    """A rank's {"params", "opt"} (or any part of it) as whole leaves,
    {path: numpy} (bf16 as its int16 bits), on every rank."""
    out = {}
    for k, t in tree_items(layout.gather(tree)):
        t = t.detach().cpu()
        out[k] = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return out


def tp_train_rank(rank, world, device, cases, trainer_case):
    """On mesh data=2,model=2: per case (float, QAT 8/8) one step's loss
    and whole gradients and its collectives; two AdamW updates with
    grad_clip 1e9 on those gradients (the whole state after them, and
    their collectives); then the Trainer (`tp_trainer_body`)."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import comm
    from repro_torch.runtime.trainer import TrainLayout

    mesh = shd.build_mesh("data=2,model=2")
    out = {}
    for name, (cfg, params, batch) in cases.items():
        layout = TrainLayout(cfg, mesh)
        # a copy: spawn hands every rank the same shared-memory tensors,
        # and AdamW updates the whole leaves a rank keeps in place
        local = layout.shard(tree_map(torch.clone, params))
        for _, p in tree_items(local):
            p.requires_grad_(True)
        comm.stats.reset()
        g, loss, _ = layout.grads(local, batch)
        grad_calls = dict(comm.stats.kind_calls)
        grads = {k.partition("/")[2]: v for k, v in
                 _whole_np(layout, {"params": g}).items()}
        ocfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)
        state = adamw.init(local, ocfg, layout.splits)
        comm.stats.reset()
        for _ in range(2):
            _, _, om = adamw.apply(local, state, g, ocfg, layout.splits,
                                   layout.groups)
        out[name] = {"loss": float(loss), "grads": grads,
                     "grad_calls": grad_calls,
                     "adamw_calls": dict(comm.stats.kind_calls),
                     "grad_norm": float(om["grad_norm"]),
                     "state": _whole_np(layout, {"params": local,
                                                 "opt": state}),
                     "local": {k: tuple(t.shape) for k, t in
                               tree_items(local)}}
    out["trainer"] = tp_trainer_body(mesh, *trainer_case)
    return out


def tp_trainer_body(mesh, cfg, params, batches, dirs):
    """The Trainer on `mesh`: (a) 3 steps from `params`; (b) 5 steps with
    checkpoints every 2, uninterrupted and with a failure injected on every
    rank at step 3 (rolled back to step 2 and replayed): histories and each
    rank's final state; (c) a restore of the meshless checkpoint in
    dirs["meshless"]."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def trainer(d, **kw):
        # a copy each (see tp_train_rank)
        return Trainer(cfg, TrainerConfig(ckpt_dir=d, opt=adamw.AdamWConfig(
            lr=1e-3), **kw), tree_map(torch.clone, params), mesh=mesh)

    out = {}
    t = trainer(dirs["history"])
    out["history"] = [t.run_step(b) for b in batches]
    pipe = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2))
    t0 = trainer(dirs["plain"], ckpt_every=2)
    h0 = t0.train(pipe, 5)
    t1 = trainer(dirs["crash"], ckpt_every=2)
    crashed = []

    def hook(step):                      # on every rank at the same step
        if step == 3 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")
    h1 = t1.train(pipe, 5, failure_hook=hook)
    out["recovery"] = {
        "h0": h0, "h1": h1, "crashed": crashed, "step": t1.step,
        "state_equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items(t0.state_tree()), tree_items(t1.state_tree()))),
        "final": _whole_np(t1.layout, t1.state_tree())}
    t2 = trainer(dirs["meshless"])
    out["restored"] = t2.restore_latest()
    out["restored_state"] = _whole_np(t2.layout, t2.state_tree())
    return out


# ---------------------------------------------------------------------------
# the mesh Engine's MLA, mamba and xLSTM mixers and the model drafter
# ---------------------------------------------------------------------------

def _block_run(kind, p, x, cfg, S):
    """One block of `kind` on `x` (B, S + 1, d): the sequence on the first
    S positions, then one step on the last from the sequence's state (MLA:
    a prefill into a dense cache, then a decode step).  Returns (sequence
    out, step out, state leaves)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba as mb
    from repro_torch.models import xlstm as xl

    B = x.shape[0]
    if kind == "mla":
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        seq, _ = attn.mla(p, x[:, :S], cfg, pos)
        cache = attn.init_mla_cache(cfg, B, S + 1, x.dtype)
        attn.mla(p, x[:, :S], cfg, pos, cache,
                 torch.zeros((B,), dtype=torch.int32))
        step, cache = attn.mla(p, x[:, S:], cfg,
                               torch.full((B, 1), S, dtype=torch.int32),
                               cache, torch.full((B,), S, dtype=torch.int32))
        return seq, step, [cache["c_kv"], cache["k_rope"]]
    fns = {"mamba": (mb.mamba_sequence, mb.mamba_step),
           "mlstm": (xl.mlstm_sequence, xl.mlstm_step),
           "slstm": (xl.slstm_sequence, xl.slstm_step)}[kind]
    seq, state = fns[0](p, x[:, :S], cfg)
    step, state = fns[1](p, x[:, S:], cfg, state)
    return seq, step, list(state)


def _reassemble(t, like, group):
    """A state leaf gathered over `group` along the one dim where this
    rank's block is smaller than the meshless leaf `like` (as is when the
    rank holds it whole)."""
    from repro_torch.parallel import comm

    dims = [d for d, (a, b) in enumerate(zip(t.shape, like.shape)) if a != b]
    return comm.all_gather(t, group, dim=dims[0]) if dims else t


def _block_pair(kind, cfg, seed, mesh, S=16):
    """The meshless block and its model-axis shards on the same 8-bit
    weights and input: {"seq", "step", "state"} -> (meshless, mesh)."""
    from repro_torch.core.bramac_linear import tree_prepare_serving
    from repro_torch.models import transformer as tf

    gen = torch.Generator().manual_seed(seed)
    pos, spec = next((i, s) for i, s in enumerate(cfg.layer_pattern)
                     if s.startswith(kind + "+"))
    p = tree_prepare_serving(tf.init_block(gen, cfg, spec, "cpu")["mixer"],
                             cfg.quant)
    x = torch.randn((2, S + 1, cfg.d_model), generator=gen)
    want = _block_run(kind, p, x, cfg, S)
    ctx = shd.ShardingCtx(mesh, shd.serve_rules(False))
    local = shd.local_config(cfg, mesh)
    path = {f"pos{pos}": {"mixer": p}}
    mine = shd.shard_params(path, ctx, whole=shd.serve_whole(cfg))[
        f"pos{pos}"]["mixer"]
    with shd.use(ctx):
        got = _block_run(kind, mine, x, local, S)
    group = mesh.group("model")
    return {"seq": (_np(want[0]), _np(got[0])),
            "step": (_np(want[1]), _np(got[1])),
            "state": [(_np(a), _np(_reassemble(b, a, group)))
                      for a, b in zip(want[2], got[2])]}


def mixers_rank(rank, world, device, runs, blocks):
    """On 4 ranks: each run (cfg, params, waves, Engine kwargs, mesh spec)
    through the mesh Engine, on "data=1,model=2" (ranks 0 and 1; ranks 2
    and 3 sit outside it) or "data=2,model=2" (all four); each block case
    (kind, cfg, seed) on model=2; whether each Engine left a ctx behind,
    and its rank's widths."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # "uses 2 of 4 devices"
        meshes = {"model=2": shd.build_mesh("data=1,model=2"),
                  "data=2,model=2": shd.build_mesh("data=2,model=2")}
    out = {"runs": {}, "blocks": {}, "ctx_after": {}, "widths": {}}
    for name, (cfg, params, waves, kw, spec) in runs.items():
        mesh = meshes[spec]
        if mesh.coords is None:
            continue
        out["runs"][name] = serve_streams(cfg, params, waves, device,
                                          mesh=mesh, **kw)
        out["ctx_after"][name] = shd.active() is not None
    mesh = meshes["model=2"]
    if mesh.coords is None:
        return out
    for name, (kind, cfg, seed) in blocks.items():
        out["blocks"][name] = _block_pair(kind, cfg, seed, mesh)
    from repro_torch.runtime.serve import Engine
    for name, (cfg, params, _, kw, _) in runs.items():
        with Engine(cfg, params, num_slots=1, max_seq=16, mesh=mesh,
                    device=device, **kw) as eng:
            c = eng.cfg
            draft = eng.drafter.cfg if eng.drafter_kind == "model" else None
            out["widths"][name] = dict(
                heads=c.num_heads, mamba=c.mamba_d_inner,
                mlstm=c.mlstm_width, slstm=c.slstm_width,
                draft_heads=None if draft is None else draft.num_heads,
                draft_bits=None if draft is None else draft.quant.bits_w)
    return out


# ---------------------------------------------------------------------------
# ZeRO-3 training over `data`
# ---------------------------------------------------------------------------

def _zero_step(mesh, cfg, params, batch, adamw_steps=2):
    """One step of `cfg` on `mesh` from the whole `params`: its loss, the
    whole gradients, the collectives by kind, and with `adamw_steps` that
    many AdamW updates (grad_clip 1e9) on those gradients: their
    collectives, the whole state after them, and the bytes of this rank's
    params, m and v by path."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import comm
    from repro_torch.runtime.trainer import TrainLayout

    layout = TrainLayout(cfg, mesh)
    # a copy: spawn hands every rank the same shared-memory tensors
    local = layout.shard(tree_map(torch.clone, params))
    for _, p in tree_items(local):
        p.requires_grad_(True)
    comm.stats.reset()
    g, loss, _ = layout.grads(local, batch)
    out = {"loss": float(loss), "grad_calls": dict(comm.stats.kind_calls),
           "grads": {k.partition("/")[2]: v for k, v in
                     _whole_np(layout, {"params": g}).items()}}
    if not adamw_steps:
        return out
    ocfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)
    state = adamw.init(local, ocfg, layout.splits)
    comm.stats.reset()
    for _ in range(adamw_steps):
        adamw.apply(local, state, g, ocfg, layout.splits, layout.groups)
    out.update(adamw_calls=dict(comm.stats.kind_calls),
               state=_whole_np(layout, {"params": local, "opt": state}),
               nbytes={k: t.numel() * t.element_size() for k, t in
                       tree_items({"params": local, "opt": state})})
    return out


def zero_train_rank(rank, world, device, steps, archs, trainer_case):
    """ZeRO-3 over `data` on 4 ranks: mesh "data=2" on ranks 0 and 1,
    "data=2,model=2" on all.  On each mesh: per case of `steps` (granite
    smoke, float and QAT 8/8) one step and two AdamW updates
    (`_zero_step`), then the Trainer (`tp_trainer_body`: history,
    recovery, a restore of the meshless checkpoint); on "data=2" one step
    of each of `archs`.  Then each mesh restores the other's final
    checkpoint."""
    import warnings

    from repro_torch.parallel import comm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # "uses 2 of 4 devices"
        meshes = {"data=2": shd.build_mesh("data=2"),
                  "data=2,model=2": shd.build_mesh("data=2,model=2")}
    cfg, params, batches, dirs = trainer_case
    out = {"lanes": _lane_checks(meshes["data=2,model=2"])}
    for name, mesh in meshes.items():
        if mesh.coords is not None:
            res = {case: _zero_step(mesh, *args)
                   for case, args in steps.items()}
            if name == "data=2":
                res.update({arch: _zero_step(mesh, *args, adamw_steps=0)
                            for arch, args in archs.items()})
            res["trainer"] = tp_trainer_body(mesh, cfg, params, batches,
                                             dirs[name])
            out[name] = res
        comm.barrier()
    # each mesh restores the other's final checkpoint (5 steps)
    for name, other in (("data=2", "data=2,model=2"),
                        ("data=2,model=2", "data=2")):
        mesh = meshes[name]
        if mesh.coords is not None:
            out[name]["cross"] = _restore_state(
                mesh, cfg, params, dirs[other]["crash"])
        comm.barrier()
    return out


def _restore_state(mesh, cfg, params, ckpt_dir):
    """The whole state a Trainer on `mesh` holds after restoring the newest
    checkpoint in `ckpt_dir`, and its step."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir, opt=adamw.AdamWConfig(
        lr=1e-3)), tree_map(torch.clone, params), mesh=mesh)
    return {"step": t.restore_latest(),
            "state": _whole_np(t.layout, t.state_tree())}


def _lane_checks(mesh):
    """`all_gather`, `reduce_scatter` and `all_reduce` over each axis of
    `mesh`, in lanes, on odd shapes (spans that do not divide evenly, the
    last one short or empty), against the result written out from every
    rank's inputs (each rank draws all ranks' tensors from one seed):
    {case: bit-equal}."""
    from repro_torch.parallel import comm

    out, lane_bytes = {}, comm.LANE_BYTES
    comm.LANE_BYTES = 4096                 # on the card: 4 MiB
    try:
        _lane_cases(mesh, out)
    finally:
        comm.LANE_BYTES = lane_bytes
    return out


def _lane_cases(mesh, out):
    from repro_torch.parallel import comm

    for axis in ("data", "model"):
        n, i, group = mesh.shape[axis], mesh.index(axis), mesh.group(axis)
        for shape in ((3, 37, 20), (64, 33), (5, 1031)):
            gen = torch.Generator().manual_seed(sum(shape))
            xs = [torch.randn(shape, generator=gen) for _ in range(n)]
            for dim in list(range(len(shape))) + [-1]:
                got = comm.all_gather(xs[i], group, dim)
                out[f"{axis} gather {shape} {dim}"] = torch.equal(
                    got, torch.cat(xs, dim))
                if shape[dim] % n == 0:
                    got = comm.reduce_scatter(xs[i], group, dim)
                    # gloo adds two ranks' values in one order
                    want = (xs[0] + xs[1]).chunk(n, dim)[i]
                    out[f"{axis} reduce-scatter {shape} {dim}"] = \
                        torch.equal(got, want)
            got = comm.all_reduce(xs[i], group, "max")
            out[f"{axis} max {shape}"] = torch.equal(
                got, torch.maximum(xs[0], xs[1]))


# ---------------------------------------------------------------------------
# expert-parallel training (attn+moe under a model axis)
# ---------------------------------------------------------------------------

EP_MESHES = ("model=2", "data=2,model=2")


def _ep_layer(mesh, p, x, cfg, cf, dispatch, cot):
    """One `ep_moe` layer on `mesh` from the whole params `p` and input
    `x`: forward (out, aux, keep) and the gradients of sum(out * cot) +
    aux with respect to x and every leaf of `p` (a stack's gradient is
    non-zero on this rank's block of experts only)."""
    from repro_torch.parallel import ep

    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    out, aux, keep = ep.ep_moe(p, x, cfg, mesh=mesh, capacity_factor=cf,
                               dispatch=dispatch, return_drops=True)
    (torch.sum(out * cot) + aux).backward()
    return {"out": _np(out), "aux": float(aux), "keep": _np(keep),
            "grads": {"x": _np(x.grad),
                      **{k: _np(v.grad) for k, v in p.items()}}}


def ep_train_rank(rank, world, device, steps, layers, trainer_case):
    """Training attn+moe archs under a `model` axis on 4 ranks: mesh
    "model=2" on ranks 0 and 1, "data=2,model=2" on all.  On each mesh:
    per case of `steps` (arch, QAT bits) one step and two AdamW updates
    (`_zero_step`) with the MoE drops the step's dispatches counted, then
    the Trainer (`tp_trainer_body`); on "model=2" each of `layers` (one
    MoE layer through `ep_moe`: (p, x, cfg, capacity factor, dispatch,
    cotangent)) forward and backward.  Then each mesh restores the other's
    final checkpoint."""
    import warnings

    from repro_torch.parallel import comm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # "uses 2 of 4 devices"
        meshes = {"model=2": shd.build_mesh("data=1,model=2"),
                  "data=2,model=2": shd.build_mesh("data=2,model=2")}
    cfg, params, batches, dirs = trainer_case
    out = {}
    for name, mesh in meshes.items():
        if mesh.coords is not None:
            res = {}
            for case, args in steps.items():
                with watched() as seen:
                    res[case] = _zero_step(mesh, *args)
                res[case]["drops"] = seen["drops"]
            if name == "model=2":
                res["layers"] = {key: _ep_layer(mesh, *args)
                                 for key, args in layers.items()}
            res["trainer"] = tp_trainer_body(mesh, cfg, params, batches,
                                             dirs[name])
            out[name] = res
        comm.barrier()
    for name, other in zip(EP_MESHES, reversed(EP_MESHES)):
        mesh = meshes[name]
        if mesh.coords is not None:
            out[name]["cross"] = _restore_state(
                mesh, cfg, params, dirs[other]["crash"])
        comm.barrier()
    return out


# ---------------------------------------------------------------------------
# tensor-parallel training of the MLA, mamba, xLSTM and cross-attention
# layers
# ---------------------------------------------------------------------------

def mixers_train_rank(rank, world, device, steps, trainer_case):
    """Training every layer kind under a `model` axis on 4 ranks: mesh
    "model=2" on ranks 0 and 1, "data=2,model=2" on all.  On each mesh:
    per case of `steps` one step and two AdamW updates (`_zero_step`),
    then the Trainer on `trainer_case` (`_checkpoint_body`).  Then each
    mesh restores the other's checkpoint."""
    import warnings

    from repro_torch.parallel import comm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # "uses 2 of 4 devices"
        meshes = {"model=2": shd.build_mesh("data=1,model=2"),
                  "data=2,model=2": shd.build_mesh("data=2,model=2")}
    cfg, params, batches, dirs = trainer_case
    out = {}
    for name, mesh in meshes.items():
        if mesh.coords is not None:
            res = {case: _zero_step(mesh, *args)
                   for case, args in steps.items()}
            res["trainer"] = _checkpoint_body(mesh, cfg, params, batches,
                                              dirs[name])
            out[name] = res
        comm.barrier()
    for name, other in zip(EP_MESHES, reversed(EP_MESHES)):
        mesh = meshes[name]
        if mesh.coords is not None:
            out[name]["cross"] = _restore_state(
                mesh, cfg, params, dirs[other]["final"])
        comm.barrier()
    return out


def _checkpoint_body(mesh, cfg, params, batches, dirs):
    """The Trainer on `mesh`: one step per batch from `params`, then its
    checkpoint in dirs["final"] (the history and the whole state it
    holds); a restore of the meshless checkpoint in dirs["meshless"]."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def trainer(d):
        # a copy each (see tp_train_rank)
        return Trainer(cfg, TrainerConfig(ckpt_dir=d, opt=adamw.AdamWConfig(
            lr=1e-3)), tree_map(torch.clone, params), mesh=mesh)

    t = trainer(dirs["final"])
    out = {"history": [t.run_step(b) for b in batches]}
    t.maybe_checkpoint(force=True)
    t._join_ckpt()
    out["final"] = _whole_np(t.layout, t.state_tree())
    t2 = trainer(dirs["meshless"])
    out["restored"] = t2.restore_latest()
    out["restored_state"] = _whole_np(t2.layout, t2.state_tree())
    return out
