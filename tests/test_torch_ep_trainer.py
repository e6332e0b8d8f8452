"""Training attn+moe archs under a `model` axis in the port: the experts
split over `model` (the reference's `expert` rule), the expert-parallel
collectives with their backward (`models.moe`'s expert split in the
global dispatch, `parallel.ep.ep_moe` in both), composed with ZeRO-3
over `data` (`runtime.trainer.TrainLayout`), against the JAX package's
single-device step and the port's meshless one.

The reference trains MoE on any mesh through GSPMD (`default_rules` maps
`expert` to `model`; its own sharded-train test fails under jax 0.9.0),
so the port's step on a mesh is held to `jax.value_and_grad` of the
reference's `loss_fn` and to the port's meshless step.  4 gloo ranks on
the CPU, spawned once for the file (`_torch_parallel_ranks.
ep_train_rank`), form "model=2" on ranks 0 and 1 and "data=2,model=2" on
all four, and train the smoke configs of qwen3-moe-30b-a3b (float and
QAT 8/8) and dbrx-132b (float) at their capacity factor 1.25, where the
meshless step drops assignments.  On each mesh:
  * one step's loss within ATOL_LOSS and every gradient, gathered to
    whole leaves, within RTOL_GRAD of each leaf's largest
    (`test_torch_train.py`'s tolerances);
  * the step's MoE drops equal the meshless step's (every rank routes
    the whole batch);
  * two AdamW updates with grad_clip 1e9 on those gradients equal the
    meshless `adamw.apply` bit for bit (params, int8 m, v);
  * each rank's bytes of params, m and v are its block under the
    reference's rules (the expert stacks cut on E over `model`, on d
    over `data`);
  * the collectives of a step, by kind, as derived below;
  * the Trainer's 3-step history within ATOL_HIST of the meshless and
    JAX Trainers', recovery bit for bit, and checkpoints that restore bit
    for bit meshless <-> model=2 <-> data=2,model=2 and into the
    reference's `ckpt.restore`.
On "model=2", one MoE layer through `ep_moe` at a no-drop and a tight
capacity: with `dispatch="per_source"` its output, aux loss, keep mask
and the gradients of sum(out * cot) + aux against `jax.value_and_grad`
of the reference's `per_source_reference(..., ep_size=2)`, with
`dispatch="global"` against the reference's `moe.moe`, within LAYER_TOL
of each tensor's largest value (f32: the ranks' sums reassociate).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import EP_MESHES, ep_train_rank, watched
from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import moe as JMoE
from repro.optim import adamw as jadamw
from repro.parallel import ep as jep
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.runtime.trainer import Trainer, TrainerConfig, TrainLayout
from repro_torch.tree import tree_items, tree_map, tree_map_with_path
from test_torch_convert import smoke_pair, to_torch
from test_torch_tp_trainer import _bits, _state_np, _to_jax
from test_torch_train import ATOL_LOSS, RTOL_GRAD, _batch
from test_torch_trainer import ATOL_HIST
from test_torch_zero_trainer import _jax_grads, _reference_block, \
    _torch_batch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

WORLD = 4
SIZES = {"model=2": {"data": 1, "model": 2},
         "data=2,model=2": {"data": 2, "model": 2}}
# step cases: (arch, QAT bits)
STEPS = {"qwen3_fp": ("qwen3-moe-30b-a3b", 0),
         "qwen3_q8": ("qwen3-moe-30b-a3b", 8),
         "dbrx_fp": ("dbrx-132b", 0)}
ADAMW = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)
# one MoE layer (f32): the ranks' gradient sums reassociate
LAYER_TOL = 1e-5
JC, TC = smoke_pair("qwen3-moe-30b-a3b")            # E=8, top-2, d=64
NO_DROP = JC.num_experts / JC.experts_per_token
CAPACITY = {"loose": NO_DROP, "tight": 1.0}
KEY = jax.random.PRNGKey(3)
LAYER_P = JMoE.init_moe(KEY, JC)
LAYER_X = np.array(jax.random.normal(jax.random.fold_in(KEY, 1),
                                     (2, 8, JC.d_model), jnp.float32))
LAYER_COT = np.array(jax.random.normal(jax.random.fold_in(KEY, 2),
                                       (2, 8, JC.d_model), jnp.float32))


def _meshless(tc, params, batch):
    """(loss, {path: gradient}, drops) of the port's meshless step."""
    local = tree_map(lambda t: t.clone().requires_grad_(True), params)
    with watched() as seen:
        g, loss, _ = TrainLayout(tc).grads(local, batch)
    return float(loss), {k: v.numpy() for k, v in tree_items(g)}, \
        seen["drops"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The ranks' inputs and outputs.  Step cases from the port's seeded
    params (the JAX package's are the same numbers), a batch of 4 rows of
    8 tokens.  The Trainer: qwen3-moe's float smoke config from the same
    params, SyntheticLM batches of 2 x 16, and a meshless Trainer's
    one-step checkpoint for the ranks to restore."""
    steps, ref = {}, {}
    for name, (arch, bits) in STEPS.items():
        jc, tc = smoke_pair(arch, **({"quant_bits": bits} if bits else {}))
        params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        batch = _batch(jc, B=4, S=8)
        steps[name] = (tc, params, _torch_batch(batch))
        ref[name] = (jc, _to_jax(params), batch)
    tc, params, _ = steps["qwen3_fp"]
    batches = [SyntheticLM(DataConfig(tc.vocab_size, 16, 2)).batch(i)
               for i in range(3)]
    meshless_dir = str(tmp_path_factory.mktemp("meshless"))
    dirs = {m: {k: str(tmp_path_factory.mktemp(f"{m}_{k}".replace(
        "=", "").replace(",", "_"))) for k in ("history", "plain", "crash")}
        for m in EP_MESHES}
    for d in dirs.values():
        d["meshless"] = meshless_dir
    meshless = Trainer(tc, TrainerConfig(
        ckpt_dir=meshless_dir, async_ckpt=False,
        opt=adamw.AdamWConfig(lr=1e-3)), tree_map(torch.clone, params))
    meshless.run_step(batches[0])
    meshless.maybe_checkpoint(force=True)
    layers = {(cap, disp): (to_torch(LAYER_P), torch.from_numpy(LAYER_X),
                            TC, cf, disp, torch.from_numpy(LAYER_COT))
              for cap, cf in CAPACITY.items()
              for disp in ("global", "per_source")}
    outs = comm.spawn(ep_train_rank, WORLD, steps, layers,
                      (tc, params, batches, dirs), device="cpu")
    # every rank of a mesh holds the same loss and the same whole leaves
    for mesh in EP_MESHES:
        ranks = [o[mesh] for o in outs if mesh in o]
        assert len(ranks) == math.prod(SIZES[mesh].values())
        for o in ranks[1:]:
            for name in STEPS:
                assert o[name]["loss"] == ranks[0][name]["loss"]
                for k, v in ranks[0][name]["state"].items():
                    np.testing.assert_array_equal(o[name]["state"][k], v)
    return {"steps": steps, "ref": ref, "out": outs,
            "meshless_step": {k: _meshless(*v) for k, v in steps.items()},
            "jp": ref["qwen3_fp"][1],
            "trainer": (tc, params, batches, dirs),
            "meshless": _state_np(meshless.state_tree())}


@pytest.fixture(scope="module")
def jax_steps(case):
    """{case: (loss, {path: gradient})} of `jax.value_and_grad(loss_fn)`."""
    return {name: _jax_grads(*ref) for name, ref in case["ref"].items()}


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_step_loss_and_grads_equal_jax_and_meshless(case, jax_steps, mesh,
                                                       name):
    """The loss and every gradient of one step, gathered to whole leaves
    (the expert stacks' blocks joined over `model` and `data`), against
    `jax.value_and_grad(loss_fn)` on the same params and batch and
    against the port's meshless step."""
    jl, jg = jax_steps[name]
    ml, mg, _ = case["meshless_step"][name]
    got = case["out"][0][mesh][name]
    for want in (jl, ml):
        assert abs(got["loss"] - want) <= ATOL_LOSS * max(1, abs(want))
    nonzero = 0
    for path, want in mg.items():
        for ref in (jg[path], want):
            scale = max(np.abs(ref).max(), 1e-6)
            np.testing.assert_allclose(got["grads"][path], ref, rtol=0,
                                       atol=RTOL_GRAD * scale, err_msg=path)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > len(mg) // 2
    assert any("moe/w_down" in p and np.abs(g).max() > 0
               for p, g in got["grads"].items())


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_step_drops_equal_meshless(case, mesh, name):
    """The meshless step drops assignments at the smoke's capacity factor
    (1.25), and every rank's step drops the same ones: each routes the
    whole batch (on data=2,model=2 after the MoE input's gather)."""
    _, _, drops = case["meshless_step"][name]
    assert drops > 0
    for o in case["out"]:
        if mesh in o:
            assert o[mesh][name]["drops"] == drops


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_adamw_equals_meshless_bit_for_bit(case, mesh, name):
    """Two AdamW updates of each rank's blocks with the step's gradients
    (grad_clip 1e9: clip is 1) equal the meshless `adamw.apply` of the
    whole gradients: params, m's int8 blocks and f32 scales, v, bit for
    bit, the expert stacks' cut over both axes included."""
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


@pytest.mark.parametrize("name", ["qwen3_fp", "dbrx_fp"])
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_rank_holds_its_block_of_params_m_and_v(case, mesh, name):
    """Each rank's bytes of every param and of its v: its block under the
    reference's rules (`spec_for`, `default_rules`: the expert stacks'
    E over `model` and d over `data`, the attention's heads over `model`
    and its `fsdp` dim over `data`, the router whole; a dim only where
    the axis size divides it); its int8 m: ceil(block / 128) rows of 128,
    with the block scales of its own blocks or of the whole leaf where
    its 128-blocks span ranks.  Every expert stack is cut on E."""
    tc, params, _ = case["steps"][name]
    sizes = SIZES[mesh]
    for o in case["out"]:
        if mesh not in o:
            continue
        got = o[mesh][name]["nbytes"]
        for path, t in tree_items(params):
            block = _reference_block(path, tuple(t.shape), sizes)
            n = math.prod(block)
            assert got[f"params/{path}"] == n * t.element_size(), path
            assert got[f"opt/v/{path}"] == n * 2, path
            assert got[f"opt/m/{path}/0"] == -(-n // 128) * 128, path
            last = max((d for d in range(t.ndim)
                        if block[d] != t.shape[d]), default=None)
            run = None if last is None else \
                block[last] * math.prod(t.shape[last + 1:])
            scales = n // 128 if run is not None and run % 128 == 0 \
                else -(-t.numel() // 128)
            assert got[f"opt/m/{path}/1"] == scales * 4, path
            if "/moe/w_" in path:
                want = list(t.shape)
                want[1] //= 2                         # E over model
                want[2 if path.endswith(("w_gate", "w_up")) else 3] //= \
                    sizes["data"]                     # d over data
                assert block == tuple(want), path


def _collectives(tc, bits: int, mesh: str) -> tuple[dict, dict]:
    """Per rank, the step's and two AdamW updates' collectives, derived.
    Under `model`: each layer's wo takes (QAT) max x, max w and the int32
    sum, or (float) one sum, its MoE layer one gather of its experts'
    outputs, the logits one gather; backward one gradient sum at the
    input of each attention, of each MoE layer's dispatch and of the
    unembed.  Under `data` too (ZeRO-3): each layer's 4 attention linears
    and 3 expert stacks, the embedding and the unembed gathered forward,
    again in backward (all but the embedding), their gradients
    reduce-scattered; each MoE input gathered over `data` and its
    gradient reduce-scattered; one mean of the loss and the whole leaves'
    gradients.  AdamW's norm one sum an axis, and the 128-blocks that
    span ranks (wq's 32 columns at these widths) one max an axis."""
    L, sizes = tc.num_layers, SIZES[mesh]
    step = {"all-reduce": L * ((3 if bits else 1) + 2) + 1,
            "all-gather": L + 1}
    if sizes["data"] > 1:
        step["all-gather"] += (7 * L + 2) + (7 * L + 1) + L
        step["reduce-scatter"] = 7 * L + 2 + L
        step["all-reduce"] += 1
    axes = sum(n > 1 for n in sizes.values())
    return step, {"all-reduce": 2 * (axes + axes)}


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_collectives_per_step_as_derived(case, mesh, name):
    tc = case["steps"][name][0]
    step, opt = _collectives(tc, STEPS[name][1], mesh)
    for o in case["out"]:
        if mesh in o:
            assert o[mesh][name]["grad_calls"] == step
            assert o[mesh][name]["adamw_calls"] == opt


@pytest.fixture(scope="module")
def histories(case, tmp_path_factory):
    """The meshless and the JAX Trainers' 3 steps of the float qwen3-moe
    smoke config from the ranks' params and zero AdamW state."""
    tc, params, batches, _ = case["trainer"]
    jc, _ = smoke_pair("qwen3-moe-30b-a3b")
    tmp = tmp_path_factory.mktemp("histories")
    jp = _to_jax(params)                 # a copy: the JAX step donates it
    jt = JTrainer(jc, JTrainerConfig(ckpt_dir=str(tmp / "j"),
                                     opt=jadamw.AdamWConfig(lr=1e-3)), jp,
                  jadamw.init(jp, jadamw.AdamWConfig(lr=1e-3)))
    tt = Trainer(tc, TrainerConfig(ckpt_dir=str(tmp / "t"),
                                   opt=adamw.AdamWConfig(lr=1e-3)),
                 tree_map(torch.clone, params))
    jpipe = JSyntheticLM(JDataConfig(jc.vocab_size, seq_len=16,
                                     global_batch=2))
    return [(jt.run_step(jpipe.batch(step)), tt.run_step(b))
            for step, b in enumerate(batches)]


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_trainer_history_equals_meshless_and_jax(case, histories, mesh):
    """Three `run_step`s of the float smoke config on the mesh: loss and
    grad norm within ATOL_HIST of the meshless Trainer's and the JAX
    Trainer's from the same params and zero AdamW state."""
    got = case["out"][0][mesh]["trainer"]["history"]
    assert len(got) == 3
    for step, (jm, tm) in enumerate(histories):
        for k in ("loss", "grad_norm"):
            for want in (jm[k], tm[k]):
                np.testing.assert_allclose(got[step][k], want,
                                           rtol=ATOL_HIST, atol=ATOL_HIST,
                                           err_msg=f"{step} {k}")


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_recovery_equals_uninterrupted(case, mesh):
    """`train` for 5 steps, checkpoints every 2 (async): a failure raised
    on every rank at step 3 rolls back to step 2 and replays; history and
    each rank's final state equal the uninterrupted run's bit for bit."""
    for o in case["out"]:
        if mesh not in o:
            continue
        rec = o[mesh]["trainer"]["recovery"]
        assert rec["crashed"] == [3] and rec["step"] == 5
        h0, h1 = rec["h0"], rec["h1"]
        assert len(h1) == 6 and h1[:3] == h0[:3] and h1[3:] == h0[2:]
        assert rec["state_equal"]
        assert all(np.isfinite(h["loss"]) for h in h1)


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_ep_checkpoints_restore_across_meshes(case, mesh):
    """Each mesh's final checkpoint (whole leaves) restores into a
    meshless Trainer, into the other mesh's Trainer and into the
    reference's `ckpt.restore`, equal bit for bit to the ranks' gathered
    state; the meshless checkpoint restores into the mesh's Trainer equal
    to the meshless state."""
    tc, params, _, dirs = case["trainer"]
    out = case["out"][0][mesh]["trainer"]
    final = out["recovery"]["final"]
    t = Trainer(tc, TrainerConfig(ckpt_dir=dirs[mesh]["crash"],
                                  opt=adamw.AdamWConfig(lr=1e-3)),
                tree_map(torch.clone, params))
    assert t.restore_latest() == 5
    got = _state_np(t.state_tree())
    assert got.keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    other = next(m for m in EP_MESHES if m != mesh)
    cross = case["out"][0][other]["cross"]
    assert cross["step"] == 5 and cross["state"].keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_array_equal(cross["state"][k], v, err_msg=k)
    jp = case["jp"]
    jtree = {"params": jp, "opt": jadamw.init(jp, jadamw.AdamWConfig())}
    jback = jckpt.restore(dirs[mesh]["crash"], 5, jtree)
    for k, v in tree_items(to_torch(jback)):
        np.testing.assert_array_equal(_bits(v), final[k], err_msg=k)
    assert out["restored"] == 1
    for k, v in case["meshless"].items():
        np.testing.assert_array_equal(out["restored_state"][k], v,
                                      err_msg=k)


@functools.cache
def _jax_layer(cap: str, dispatch: str):
    """The reference's layer at capacity `cap`: (out, aux, keep or None,
    {"x", "router", "w_gate", "w_up", "w_down": gradient of
    sum(out * cot) + aux})."""
    cf = CAPACITY[cap]

    def f(p, x):
        if dispatch == "per_source":
            out, aux, keep = jep.per_source_reference(
                p, x, JC, ep_size=2, capacity_factor=cf)
        else:
            (out, aux), keep = JMoE.moe(p, x, JC, capacity_factor=cf), None
        return jnp.sum(out * jnp.asarray(LAYER_COT)) + aux, (out, aux, keep)

    (_, (out, aux, keep)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(LAYER_P, jnp.asarray(LAYER_X))
    grads = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in
                                     gp.items()}}
    return np.asarray(out), float(aux), \
        None if keep is None else np.asarray(keep), grads


@pytest.mark.parametrize("dispatch", ["per_source", "global"])
@pytest.mark.parametrize("cap", list(CAPACITY))
def test_ep_moe_layer_grads_equal_jax(case, cap, dispatch):
    """One MoE layer through `ep_moe` on model=2, at a no-drop and a tight
    capacity: its output, aux loss (and per_source's keep mask), and the
    gradients of sum(out * cot) + aux with respect to x, the router and
    the three expert stacks (each rank's block of the experts, joined),
    against `jax.value_and_grad` of the reference's
    `per_source_reference(..., ep_size=2)` (per_source) or `moe.moe`
    (global), within LAYER_TOL of each tensor's largest value."""
    want_out, want_aux, want_keep, want = _jax_layer(cap, dispatch)
    ranks = [o["model=2"]["layers"][(cap, dispatch)] for o in case["out"]
             if "model=2" in o]
    assert len(ranks) == 2
    if cap == "tight":
        assert not ranks[0]["keep"].all()         # the capacity drops
    for r in ranks:
        np.testing.assert_allclose(r["out"], want_out, rtol=0, atol=LAYER_TOL
                                   * np.abs(want_out).max())
        assert abs(r["aux"] - want_aux) <= LAYER_TOL * abs(want_aux)
        if want_keep is not None:
            np.testing.assert_array_equal(r["keep"], want_keep)
        for k in ("x", "router"):
            np.testing.assert_allclose(
                r["grads"][k], want[k], rtol=0,
                atol=LAYER_TOL * np.abs(want[k]).max(), err_msg=k)
    E = JC.num_experts
    for k in ("w_gate", "w_up", "w_down"):
        for i, r in enumerate(ranks):           # only its block is touched
            g = r["grads"][k].reshape(2, E // 2, -1)
            assert not g[1 - i].any(), k
        got = ranks[0]["grads"][k] + ranks[1]["grads"][k]
        np.testing.assert_allclose(got, want[k], rtol=0, atol=LAYER_TOL
                                   * np.abs(want[k]).max(), err_msg=k)
