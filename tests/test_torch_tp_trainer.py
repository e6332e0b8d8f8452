"""Tensor-parallel training in the port (`runtime.trainer.TrainLayout`, the
Trainer on a `model` axis, ZeRO-3 over `data`, `optim.adamw` on split
leaves, whole-leaf checkpoints) against the JAX package's single-device
step and the port's meshless one.

The reference trains on any mesh through GSPMD; its own sharded-train test
fails under jax 0.9.0, so the port's step on a mesh is held to the
reference's single-device `loss_fn` under `jax.value_and_grad` and to the
port's meshless step.  4 gloo ranks on the CPU, spawned once for the file
(`_torch_parallel_ranks.tp_train_rank`), form the mesh data=2,model=2 and
train granite-8b's smoke config, float and QAT 8/8:
  * one step's loss within ATOL_LOSS and every gradient, gathered to
    whole leaves, within RTOL_GRAD of each leaf's largest
    (`test_torch_train.py`'s tolerances: f32 reassociation of the shard
    sums and means);
  * two AdamW updates with grad_clip 1e9 (so the clip factor is exactly
    1) on those gradients: params, the int8 m's blocks and scales and v,
    gathered, equal the meshless `adamw.apply` bit for bit.  The mesh is
    ZeRO-3 over `data`, so every large leaf is cut on both axes (the
    embedding on d over `data` only); at these widths the 128-blocks span
    ranks, so this holds the block grid to the whole leaf's;
  * the collectives of a step, by kind, as derived below;
  * the Trainer's 3-step history within ATOL_HIST of the meshless
    Trainer's and the JAX Trainer's (`test_torch_trainer.py`'s);
  * recovery from a failure injected on every rank equals the
    uninterrupted run bit for bit;
  * the mesh's checkpoint restores into a meshless Trainer and into the
    reference's `ckpt.restore` bit for bit, and a meshless checkpoint
    restores into the mesh's Trainer bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import tp_train_rank
from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.runtime.trainer import Trainer, TrainerConfig, TrainLayout
from repro_torch.tree import tree_items, tree_leaves, tree_map, \
    tree_map_with_path
from test_torch_convert import smoke_pair, to_torch
from test_torch_train import ATOL_LOSS, RTOL_GRAD, _batch
from test_torch_trainer import ATOL_HIST

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

WORLD = 4                  # data=2 x model=2
BITS = {"fp": 0, "q8": 8}
ADAMW = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 as its int16 bits (the ranks' encoding)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _state_np(tree) -> dict:
    return {k: _bits(t) for k, t in tree_items(tree)}


def _to_jax(tree):
    """A tree of f32 torch tensors as the JAX package's params."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.array(tree.detach().numpy())         # a copy


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The ranks' inputs and outputs.  Step cases: smoke granite from the
    port's seeded params (the JAX package's are the same numbers), a batch
    of 4 rows of 8 tokens.  The
    Trainer: the float smoke config from the same params, SyntheticLM
    batches of 2 x 16, and a meshless Trainer's one-step checkpoint for
    the ranks to restore."""
    steps, ref = {}, {}
    jc, tc = smoke_pair("granite-8b")
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = _to_jax(params)                         # the QAT config's too
    for name, bits in BITS.items():
        jc, tc = smoke_pair("granite-8b", **({"quant_bits": bits}
                                             if bits else {}))
        batch = _batch(jc, B=4, S=8)
        steps[name] = (tc, params,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
        ref[name] = (jc, jp, batch)
    jc, tc = smoke_pair("granite-8b")
    batches = [SyntheticLM(DataConfig(tc.vocab_size, 16, 2)).batch(i)
               for i in range(3)]
    dirs = {k: str(tmp_path_factory.mktemp(k))
            for k in ("history", "plain", "crash", "meshless")}
    meshless = Trainer(tc, TrainerConfig(
        ckpt_dir=dirs["meshless"], async_ckpt=False,
        opt=adamw.AdamWConfig(lr=1e-3)), tree_map(torch.clone, params))
    meshless.run_step(batches[0])
    meshless.maybe_checkpoint(force=True)
    outs = comm.spawn(tp_train_rank, WORLD, steps,
                      (tc, params, batches, dirs), device="cpu")
    # every rank holds the same loss, and the first data index the same
    # whole leaves
    for o in outs[1:]:
        for name in BITS:
            assert o[name]["loss"] == outs[0][name]["loss"]
    for k, v in outs[0]["q8"]["state"].items():
        np.testing.assert_array_equal(outs[1]["q8"]["state"][k], v)
    return {"steps": steps, "ref": ref, "out": outs, "jp": jp, "trainer": (
        tc, params, batches, dirs), "meshless": _state_np(
            meshless.state_tree())}


@pytest.mark.parametrize("name", list(BITS))
def test_tp_step_loss_and_grads_equal_jax_and_meshless(case, name):
    """The loss and every gradient of one step on data=2,model=2, gathered
    to whole leaves, against `jax.value_and_grad(loss_fn)` on the same
    params and batch and against the port's meshless step."""
    jc, jp, batch = case["ref"][name]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jc), has_aux=True))(jp)
    tc, params, tbatch = case["steps"][name]
    local = tree_map(lambda t: t.clone().requires_grad_(True), params)
    mg, ml, _ = TrainLayout(tc).grads(local, tbatch)
    got = case["out"][0][name]
    assert abs(got["loss"] - float(jl)) <= ATOL_LOSS * max(1, abs(float(jl)))
    assert abs(got["loss"] - float(ml)) <= ATOL_LOSS * max(1, abs(float(ml)))
    jleaves = dict(tree_items(to_torch(jg)))
    nonzero = 0
    for path, want in tree_items(mg):
        for ref in (jleaves[path].numpy(), want.numpy()):
            scale = max(np.abs(ref).max(), 1e-6)
            np.testing.assert_allclose(got["grads"][path], ref, rtol=0,
                                       atol=RTOL_GRAD * scale, err_msg=path)
        nonzero += bool(np.abs(want.numpy()).max() > 0)
    assert nonzero > len(jleaves) // 2


@pytest.mark.parametrize("name", list(BITS))
def test_tp_adamw_equals_meshless_bit_for_bit(case, name):
    """Two AdamW updates of each rank's blocks with the step's gradients
    (grad_clip 1e9: clip is 1) equal the meshless `adamw.apply` of the
    whole gradients: params, m's int8 blocks and f32 scales, v, bit for
    bit.  The split leaves hold a part of their whole shape on a rank:
    the linears a quarter, the embedding (cut on d over `data`) a
    half."""
    tc, params, _ = case["steps"][name]
    got = case["out"][0][name]
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
    shapes = dict(tree_items(params))
    for path, shape in got["local"].items():
        full = tuple(shapes[path].shape)
        split = path.endswith(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                               "w_down", "unembed", "embedding"))
        assert (shape != full) == split, (path, shape, full)


@pytest.mark.parametrize("name", list(BITS))
def test_tp_collectives_per_step_as_derived(case, name):
    """Per rank and step at the smoke depth (L = 2) on data=2,model=2:
    forward, each layer's wo and w_down take (QAT) max x, max w and the
    int32 sum, or (float) one sum, and the logits one gather; backward,
    one gradient sum at the input of each attention, MLP and the unembed.
    ZeRO-3 over `data`: each layer's 7 linears, the embedding and the
    unembed are gathered once forward, each saved one (all but the
    embedding, whose lookup saves no weight) once more backward, and
    every gradient of theirs reduce-scattered; the loss and the whole
    leaves' gradients (the norms) take one mean.  AdamW's norm takes one
    sum an axis, and the blocks that span ranks one max an axis."""
    tc, params, _ = case["steps"][name]
    L, got = tc.num_layers, case["out"][0][name]
    per_row = 3 if BITS[name] else 1
    fwd, bwd = L * 2 * per_row, L * 2 + 1
    assert got["grad_calls"] == {"all-reduce": fwd + bwd + 1,
                                 "all-gather": 1 + (7 * L + 2) + (7 * L + 1),
                                 "reduce-scatter": 7 * L + 2}
    assert got["adamw_calls"] == {"all-reduce": 2 * (2 + 2)}


def test_tp_trainer_history_equals_meshless_and_jax(case, tmp_path):
    """Three `run_step`s of the float smoke config on data=2,model=2:
    loss and grad norm within ATOL_HIST of the meshless Trainer's and the
    JAX Trainer's from the same params and zero AdamW state."""
    tc, params, batches, _ = case["trainer"]
    jc, _ = smoke_pair("granite-8b")
    jp = case["jp"]
    ocfg = dict(lr=1e-3)
    jt = JTrainer(jc, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                     opt=jadamw.AdamWConfig(**ocfg)), jp,
                  jadamw.init(jp, jadamw.AdamWConfig(**ocfg)))
    tt = Trainer(tc, TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                   opt=adamw.AdamWConfig(**ocfg)),
                 tree_map(torch.clone, params))
    jpipe = JSyntheticLM(JDataConfig(jc.vocab_size, seq_len=16,
                                     global_batch=2))
    got = case["out"][0]["trainer"]["history"]
    assert len(got) == 3
    for step, b in enumerate(batches):
        jm, tm = jt.run_step(jpipe.batch(step)), tt.run_step(b)
        for k in ("loss", "grad_norm"):
            for want in (jm[k], tm[k]):
                np.testing.assert_allclose(got[step][k], want,
                                           rtol=ATOL_HIST, atol=ATOL_HIST,
                                           err_msg=f"{step} {k}")


def test_tp_recovery_equals_uninterrupted(case):
    """`train` for 5 steps, checkpoints every 2 (async): a failure raised
    on every rank at step 3 rolls back to step 2 and replays; history and
    each rank's final state equal the uninterrupted run's bit for bit."""
    for o in case["out"]:
        rec = o["trainer"]["recovery"]
        assert rec["crashed"] == [3] and rec["step"] == 5
        h0, h1 = rec["h0"], rec["h1"]
        assert len(h1) == 6 and h1[:3] == h0[:3] and h1[3:] == h0[2:]
        assert rec["state_equal"]
        assert all(np.isfinite(h["loss"]) for h in h1)


def test_tp_checkpoints_restore_across_topologies(case, tmp_path):
    """The mesh's final checkpoint (whole leaves) restores into a meshless
    Trainer and into the reference's `ckpt.restore`, equal bit for bit to
    the ranks' gathered state; the meshless checkpoint restores into the
    mesh's Trainer equal to the meshless state."""
    tc, params, _, dirs = case["trainer"]
    out = case["out"][0]["trainer"]
    final = out["recovery"]["final"]
    t = Trainer(tc, TrainerConfig(ckpt_dir=dirs["crash"],
                                  opt=adamw.AdamWConfig(lr=1e-3)),
                tree_map(torch.clone, params))
    assert t.restore_latest() == 5
    got = _state_np(t.state_tree())
    assert got.keys() == final.keys()
    for k, v in final.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jp = case["jp"]
    jtree = {"params": jp, "opt": jadamw.init(jp, jadamw.AdamWConfig())}
    jback = jckpt.restore(dirs["crash"], 5, jtree)
    for k, v in tree_items(to_torch(jback)):
        np.testing.assert_array_equal(_bits(v), final[k], err_msg=k)
    assert out["restored"] == 1
    for k, v in case["meshless"].items():
        np.testing.assert_array_equal(out["restored_state"][k], v,
                                      err_msg=k)


def test_adamw_refuses_a_split_leaf_on_its_own_block_grid():
    """A rank whose blocks of a leaf span ranks (here 32 of 64 columns)
    must keep the whole leaf's block grid: AdamW raises, naming the leaf,
    for a first moment built on the rank's own grid."""
    from repro_torch.parallel.sharding import Cut, Split
    split = Split((4, 64), (Cut(1, 2, 0, "model"),))
    params = {"w": torch.zeros(split.local)}
    g = {"w": torch.ones(split.local)}
    own = adamw.init(params, ADAMW)                   # no splits: own grid
    with pytest.raises(ValueError, match="^w: .*whole leaf's grid"):
        adamw.apply(params, own, g, ADAMW, {"w": split})
    state = adamw.init(params, ADAMW, {"w": split})
    assert state["m"]["w"].scale.shape == (2, 1)      # the whole leaf's
