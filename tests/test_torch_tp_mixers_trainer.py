"""Training the MLA, mamba, mLSTM, sLSTM and cross-attention layers under a
`model` axis in the port, alone and composed with ZeRO-3 over `data`
(`runtime.trainer.TrainLayout`), against the JAX package's
single-device step and the port's meshless one.

The reference trains these archs on any mesh through GSPMD with its
`_PARAM_RULES`; the port splits them as its mesh Engine does: mamba's
`w_in` and the mLSTM's `w_up` in their column parts (rank r holds block
r of each part: a parted `sharding.Cut`), mamba's B/C and dt projections
and the sLSTM's cell and `w_up` whole on `model` (`serve_whole`; their
`fsdp` cut over `data` stands), the mixers' collectives carrying their
backward.  4 gloo ranks on the CPU, spawned once for the file
(`_torch_parallel_ranks.mixers_train_rank`), form "model=2" on ranks 0
and 1 and "data=2,model=2" on all four, and train the smoke configs of
minicpm3-4b (MLA), xlstm-1.3b (mLSTM and sLSTM; its sLSTM width taken to
96, `slstm_proj_factor=1.5`, as the sLSTM's 85 does not split two ways),
jamba-1.5-large-398b (mamba, attention, MoE) and llama-3.2-vision-11b
(cross-attention), float, and xlstm and jamba QAT 8/8 too.  On each mesh:
  * one step's loss within ATOL_LOSS and every gradient, gathered to
    whole leaves, within RTOL_GRAD of each leaf's largest
    (`test_torch_train.py`'s tolerances), against `jax.value_and_grad` of
    the reference's `loss_fn` and the port's meshless step;
  * two AdamW updates with grad_clip 1e9 on those gradients equal the
    meshless `adamw.apply` bit for bit (params, int8 m blocks and scales,
    v), the parted leaves' 128-blocks spanning both ranks;
  * each rank's bytes of params, m and v: its block under the reference's
    rules, but for the leaves the port keeps whole on `model`;
  * the collectives of a step, by kind, as derived below;
  * jamba's Trainer: 3 steps within ATOL_HIST of the meshless Trainer's,
    and their checkpoint restores bit for bit meshless <-> model=2 <->
    data=2,model=2 and into the reference's `ckpt.restore`.
The JAX references compile while the ranks run (the spawn waits in a
thread of the test process).
The parted `Split` round-trips its blocks (`take`, `join`,
`whole_index`, `grid`) against the whole leaf; `check_mesh` still
refuses an axis other than `data` and `model`; on the CPU no row of the
xLSTM depends on the batch it runs in (`scripts/torch_rows_probe.py`).
"""
import math
import re
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import EP_MESHES, mixers_train_rank
from repro.checkpoint import ckpt as jckpt
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import trainer as ttrainer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items, tree_map, tree_map_with_path
from test_torch_convert import smoke_pair, to_torch
from test_torch_tp_trainer import _bits, _state_np, _to_jax
from test_torch_train import ATOL_LOSS, RTOL_GRAD, _batch
from test_torch_trainer import ATOL_HIST
from test_torch_zero_trainer import _jax_grads, _meshless, _reference_block, \
    _torch_batch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

WORLD = 4
SIZES = {"model=2": {"data": 1, "model": 2},
         "data=2,model=2": {"data": 2, "model": 2}}
MB, XL, JB, LV = ("minicpm3-4b", "xlstm-1.3b", "jamba-1.5-large-398b",
                  "llama-3.2-vision-11b")
XL_SPLIT = {"slstm_proj_factor": 1.5}    # sLSTM width 96: splits two ways
# step cases: (arch, config overrides, QAT bits)
STEPS = {"minicpm3_fp": (MB, {}, 0), "xlstm_fp": (XL, XL_SPLIT, 0),
         "xlstm_q8": (XL, XL_SPLIT, 8), "jamba_fp": (JB, {}, 0),
         "jamba_q8": (JB, {}, 8), "vision_fp": (LV, {}, 0)}
ADAMW = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)


def _pair(arch, over, bits):
    return smoke_pair(arch, **over, **({"quant_bits": bits} if bits else {}))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The ranks' inputs and outputs.  Step cases from the port's seeded
    params (the JAX package's are the same numbers), a batch of 4 rows of
    8 tokens.  The Trainer: jamba's float smoke config from the same
    params, SyntheticLM batches of 2 x 16, and a meshless Trainer's
    one-step checkpoint for the ranks to restore.  While the ranks run,
    the JAX package's and the port's meshless steps and the meshless
    Trainer's 3 steps."""
    steps, ref = {}, {}
    for name, args in STEPS.items():
        jc, tc = _pair(*args)
        params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        batch = _batch(jc, B=4, S=8)
        steps[name] = (tc, params, _torch_batch(batch))
        ref[name] = (jc, _to_jax(params), batch)
    tc, params, _ = steps["jamba_fp"]
    batches = [SyntheticLM(DataConfig(tc.vocab_size, 16, 2)).batch(i)
               for i in range(3)]
    meshless_dir = str(tmp_path_factory.mktemp("meshless"))
    dirs = {m: {k: str(tmp_path_factory.mktemp(f"{m}_{k}".replace(
        "=", "").replace(",", "_"))) for k in ("final",)}
        for m in EP_MESHES}
    for d in dirs.values():
        d["meshless"] = meshless_dir
    meshless = Trainer(tc, TrainerConfig(
        ckpt_dir=meshless_dir, async_ckpt=False,
        opt=adamw.AdamWConfig(lr=1e-3)), tree_map(torch.clone, params))
    meshless.run_step(batches[0])
    meshless.maybe_checkpoint(force=True)
    ranks = {}

    def spawn():
        try:
            ranks["out"] = comm.spawn(mixers_train_rank, WORLD, steps,
                                      (tc, params, batches, dirs),
                                      device="cpu")
        except BaseException as e:       # raised in the test's thread
            ranks["error"] = e
    thread = threading.Thread(target=spawn)
    thread.start()
    jax_steps = {name: _jax_grads(*r) for name, r in ref.items()}
    meshless_step = {k: _meshless(v[0], v[1], ref[k][2])
                     for k, v in steps.items()}
    history = Trainer(tc, TrainerConfig(
        ckpt_dir=str(tmp_path_factory.mktemp("history")),
        opt=adamw.AdamWConfig(lr=1e-3)), tree_map(torch.clone, params))
    history = [history.run_step(b) for b in batches]
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    outs = ranks["out"]
    # every rank of a mesh holds the same loss and the same whole leaves
    for mesh in EP_MESHES:
        ranks = [o[mesh] for o in outs if mesh in o]
        assert len(ranks) == math.prod(SIZES[mesh].values())
        for o in ranks[1:]:
            for name in STEPS:
                assert o[name]["loss"] == ranks[0][name]["loss"]
                for k, v in ranks[0][name]["state"].items():
                    np.testing.assert_array_equal(o[name]["state"][k], v)
    return {"steps": steps, "out": outs, "jax_step": jax_steps,
            "meshless_step": meshless_step, "jp": ref["jamba_fp"][1],
            "trainer": (tc, params, batches, dirs), "history": history,
            "meshless": _state_np(meshless.state_tree())}


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_step_loss_and_grads_equal_jax_and_meshless(case, mesh, name):
    """The loss and every gradient of one step, gathered to whole leaves
    (the parted leaves' blocks joined part by part), against
    `jax.value_and_grad(loss_fn)` on the same params and batch and
    against the port's meshless step; the leaves the ranks read only in
    part (the MLA latents' projections and norms, mamba's B/C and dt
    projections, the mLSTM's gates and norm, the sLSTM's `w_up`, the
    cross-attention's `kv_norm`) among them."""
    jl, jg = case["jax_step"][name]
    ml, mg = case["meshless_step"][name]
    got = case["out"][0][mesh][name]
    for want in (jl, ml):
        assert abs(got["loss"] - want) <= ATOL_LOSS * max(1, abs(want))
    assert got["grads"].keys() == mg.keys()
    nonzero = 0
    for path, want in mg.items():
        for ref in (jg[path], want):
            scale = max(np.abs(ref).max(), 1e-6)
            np.testing.assert_allclose(got["grads"][path], ref, rtol=0,
                                       atol=RTOL_GRAD * scale, err_msg=path)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > len(mg) // 2


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_adamw_equals_meshless_bit_for_bit(case, mesh, name):
    """Two AdamW updates of each rank's blocks with the step's gradients
    (grad_clip 1e9: clip is 1) equal the meshless `adamw.apply` of the
    whole gradients: params, m's int8 blocks and f32 scales, v, bit for
    bit, the parted leaves (mamba's `w_in`, the mLSTM's `w_up`: a
    128-block of the whole row spans both ranks in each part) included."""
    tc, params, _ = case["steps"][name]
    got = case["out"][0][mesh][name]
    whole = tree_map(torch.clone, params)
    g = tree_map_with_path(lambda k, _: torch.from_numpy(
        got["grads"][k]), whole)
    state = adamw.init(whole, ADAMW)
    with torch.no_grad():
        for _ in range(2):
            adamw.apply(whole, state, g, ADAMW)
    want = _state_np({"params": whole, "opt": state})
    assert want.keys() == got["state"].keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


def _port_block(path: str, shape, sizes: dict, cfg) -> tuple:
    """The block of a param one rank holds: the reference's
    (`_reference_block`), but whole on `model` where the port keeps the
    leaf whole (`serve_whole`: its `fsdp` cut over `data` stands)."""
    block = list(_reference_block(path, shape, sizes))
    if any(re.search(p, path) for p in shd.serve_whole(cfg)):
        spec = jshd.spec_for(path.replace("/", "."), len(shape))
        for d, name in enumerate(spec):
            if name in ("tp", "expert"):
                block[d] = shape[d]
    return tuple(block)


@pytest.mark.parametrize("name", ["minicpm3_fp", "xlstm_fp", "jamba_fp",
                                  "vision_fp"])
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_rank_holds_its_block_of_params_m_and_v(case, mesh, name):
    """Each rank's bytes of every param and of its v: its block under the
    reference's rules (1/n along each cut dim where n divides it), but
    whole on `model` for the leaves the port keeps whole; its int8 m:
    ceil(block / 128) rows of 128, with the whole leaf's block scales
    where its 128-blocks span ranks.  The parted leaves are cut."""
    tc, params, _ = case["steps"][name]
    sizes = SIZES[mesh]
    parted = 0
    for o in case["out"]:
        if mesh not in o:
            continue
        got = o[mesh][name]["nbytes"]
        for path, t in tree_items(params):
            block = _port_block(path, tuple(t.shape), sizes, tc)
            n = math.prod(block)
            assert got[f"params/{path}"] == n * t.element_size(), path
            assert got[f"opt/v/{path}"] == n * 2, path
            assert got[f"opt/m/{path}/0"] == -(-n // 128) * 128, path
            parted += bool(re.search(r"mixer/(w_in|w_up)$", path)
                           and block[-1] < t.shape[-1])
    if name in ("xlstm_fp", "jamba_fp"):
        assert parted


def _collectives(name: str, mesh: str) -> tuple[dict, dict]:
    """Per rank, the step's and two AdamW updates' collectives, derived.
    Under `model`: forward, each row-parallel linear's sum (QAT: max x,
    max w and the int32 sum), each mamba layer's two gathers (the conv
    output, y·silu(z)), each mLSTM layer's two (xm, h), each MoE layer's
    gather of its experts' outputs, the logits' gather; backward, one
    gradient sum at the input of each column-parallel block (attention,
    cross-attention's queries, the FF, the MoE dispatch, mamba's and the
    mLSTM's up projections, the unembed), at MLA's latents, at mamba's
    whole B·C and dt (one chunk at S=8) and at the sLSTM's gelu(a)·b, a
    reduce-scatter for each mLSTM gather, and one sum of the
    `model_partial` leaves' gradients (the mLSTM's gates and norm, the
    cross-attention's kv_norm).  Under `data` too (ZeRO-3): each leaf cut
    on its `fsdp` dim gathered forward, again in backward (all but the
    embedding), its gradient reduce-scattered; each MoE input gathered
    over `data` and its gradient reduce-scattered; one mean of the loss
    and the whole leaves' gradients.  AdamW's norm one sum an axis, and
    the 128-blocks that span ranks one max an axis."""
    arch, _, bits = STEPS[name]
    row = 3 if bits else 1
    # per arch: (row-parallel linears, other model all-reduces, model
    # all-gathers, reduce-scatters, leaves cut over data, MoE layers)
    L = {MB: (4, 5, 1, 0, 14, 0),
         XL: (8, 10, 15, 14, 41, 0),
         JB: (5, 24, 19, 0, 37, 4),
         LV: (10, 12, 1, 0, 37, 0)}[arch]
    rows, other, gathers, scatters, zero, moe = L
    step = {"all-reduce": rows * row + other, "all-gather": gathers}
    if scatters:
        step["reduce-scatter"] = scatters
    if SIZES[mesh]["data"] > 1:
        step["all-gather"] += zero + (zero - 1) + moe
        step["reduce-scatter"] = step.get("reduce-scatter", 0) + zero + moe
        step["all-reduce"] += 1
    axes = sum(n > 1 for n in SIZES[mesh].values())
    return step, {"all-reduce": 2 * (axes + axes)}


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_collectives_per_step_as_derived(case, mesh, name):
    step, opt = _collectives(name, mesh)
    for o in case["out"]:
        if mesh in o:
            assert o[mesh][name]["grad_calls"] == step
            assert o[mesh][name]["adamw_calls"] == opt


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_trainer_history_equals_meshless(case, mesh):
    """Three `run_step`s of jamba's float smoke config on the mesh: loss
    and grad norm within ATOL_HIST of the meshless Trainer's from the same
    params and zero AdamW state."""
    got = case["out"][0][mesh]["trainer"]["history"]
    assert len(got) == 3
    for step, want in enumerate(case["history"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[step][k], want[k],
                                       rtol=ATOL_HIST, atol=ATOL_HIST,
                                       err_msg=f"{step} {k}")


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixer_checkpoints_restore_across_meshes(case, mesh):
    """jamba's checkpoint after the 3 steps on each mesh (whole leaves, the
    parted `w_in` joined part by part) restores into a meshless Trainer,
    into the other mesh's Trainer and into the reference's
    `ckpt.restore`, equal bit for bit to the ranks' gathered state; the
    meshless checkpoint restores into the mesh's Trainer equal to the
    meshless state."""
    tc, params, _, dirs = case["trainer"]
    out = case["out"][0][mesh]["trainer"]
    final = out["final"]
    t = Trainer(tc, TrainerConfig(ckpt_dir=dirs[mesh]["final"],
                                  opt=adamw.AdamWConfig(lr=1e-3)),
                tree_map(torch.clone, params))
    assert t.restore_latest() == 3
    got = _state_np(t.state_tree())
    assert got.keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    other = next(m for m in EP_MESHES if m != mesh)
    cross = case["out"][0][other]["cross"]
    assert cross["step"] == 3 and cross["state"].keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_array_equal(cross["state"][k], v, err_msg=k)
    jp = case["jp"]
    jtree = {"params": jp, "opt": jadamw.init(jp, jadamw.AdamWConfig())}
    jback = jckpt.restore(dirs[mesh]["final"], 3, jtree)
    for k, v in tree_items(to_torch(jback)):
        np.testing.assert_array_equal(_bits(v), final[k], err_msg=k)
    assert out["restored"] == 1
    for k, v in case["meshless"].items():
        np.testing.assert_array_equal(out["restored_state"][k], v,
                                      err_msg=k)


# --- the parted Split, on one process ----------------------------------------

# (whole shape, cuts as (dim, n, parts) over "data" then "model")
PARTED = {"w_in": ((2, 8, 24), ((1, 2, 1), (2, 2, 2))),
          "w_gates": ((6, 32), ((1, 2, 4),)),
          "deep": ((4, 3, 40), ((0, 2, 1), (2, 2, 2)))}
PER = 2                        # the grid's block: each run holds whole ones


def _splits(shape, cuts):
    """Every rank's Split of a leaf of `shape` under `cuts`, rank-major
    over the cuts (the last one's index fastest)."""
    axes = ("data", "model")[-len(cuts):]
    grid = [()]
    for dim, n, _ in cuts:
        grid = [g + (i,) for g in grid for i in range(n)]
    return [shd.Split(shape, tuple(shd.Cut(dim, n, i, a, parts) for
                                   (dim, n, parts), i, a in
                                   zip(cuts, coords, axes)))
            for coords in grid]


def _joins(splits, whole):
    """Each rank's `join` of its block, every gather emulated: along a
    cut, the blocks of the ranks that share this rank's other indices, in
    rank order, each whole along the cuts joined before it."""
    def upto(split, cut):
        t, on = whole, False
        for c in split.cuts:
            on = on or c.axis == cut.axis
            if on:
                t = shd.grouped_block(t, c.dim, c.n, c.i, c.parts)
        return t

    def gather(s):
        return lambda t, c: torch.cat(
            [upto(o, c) for o in splits if all(
                x.i == y.i for x, y in zip(o.cuts, s.cuts)
                if x.axis != c.axis)], c.dim)
    return [s.join(s.take(whole), gather(s)) for s in splits]


@pytest.mark.parametrize("name", list(PARTED))
def test_parted_split_round_trips(name):
    """A leaf cut in column parts: each rank's `take` holds block i of
    every part (`sharding.grouped_block`); `join` over all ranks' blocks
    gives the whole leaf back; `whole_index` of a rank's flat positions
    names the whole leaf's values it holds, and every position is held by
    one rank; `grid(PER)` takes and joins the leaf's PER-value blocks the
    same way, in the rank's own flat order."""
    shape, cuts = PARTED[name]
    whole = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    splits = _splits(shape, cuts)
    seen = torch.zeros(whole.numel(), dtype=torch.int64)
    for s in splits:
        t = s.take(whole)
        want = whole
        for c in s.cuts:
            want = shd.grouped_block(want, c.dim, c.n, c.i, c.parts)
        assert torch.equal(t, want) and tuple(t.shape) == s.local
        idx = s.whole_index(torch.arange(t.numel()))
        assert torch.equal(whole.reshape(-1)[idx], t.reshape(-1))
        seen[idx] += 1
    assert (seen == 1).all()
    assert all(torch.equal(j, whole) for j in _joins(splits, whole))
    assert any(c.parts > 1 for c in splits[0].cuts)
    assert all(s.run % PER == 0 for s in splits)
    grids = [s.grid(PER) for s in splits]
    blocks = whole.reshape(-1, PER).sum(-1).reshape(grids[0].whole)
    for s, g in zip(splits, grids):
        idx = s.whole_index(torch.arange(math.prod(s.local)))
        mine = whole.reshape(-1)[idx].reshape(-1, PER).sum(-1)
        assert torch.equal(g.take(blocks).reshape(-1), mine)
    assert all(torch.equal(j, blocks) for j in _joins(grids, blocks))


def test_check_mesh_refuses_other_axes():
    """Every layer kind trains on a data x model mesh; an axis other than
    `data` and `model` is refused."""
    for arch, over, bits in STEPS.values():
        _, tc = _pair(arch, over, bits)
        for spec in ("model=2", "data=2,model=2"):
            ttrainer.check_mesh(tc, shd.dry_mesh(spec))
        with pytest.raises(NotImplementedError, match="pod"):
            ttrainer.check_mesh(tc, shd.dry_mesh("pod=2,model=2"))


def test_rows_probe_sees_no_row_depend_on_its_batch_on_the_cpu():
    """`scripts/torch_rows_probe.py` on xlstm-1.3b smoke (QAT 8/8) on the
    CPU: every op output on the first half's rows equals the whole
    batch's bit for bit, so only the loss's own means part (0-dim), and
    the halves' mean loss is the whole batch's within f32 rounding.  (On
    the card the mLSTM's gate product parts: chip_smoke.py 15k(e) holds
    its data=2 step to the meshless step on the ranks' rows.)"""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "torch_rows_probe.py")
    spec = importlib.util.spec_from_file_location("torch_rows_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    out = probe.main(["--arch", XL, "--smoke", "--device", "cpu",
                      "--seq", "8"])
    assert out["compared"] > out["ops"] // 2
    assert out["first"] and all(d["shape"] == [] for d in out["first"])
    assert out["rel"] < 1e-6
