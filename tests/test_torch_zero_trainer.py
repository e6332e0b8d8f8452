"""ZeRO-3 training over `data` in the port (`runtime.trainer.TrainLayout`:
params, int8 m and v cut on the reference's `fsdp` dims, gathered per use,
gradients reduce-scattered) against the JAX package's single-device step
and the port's meshless one.

The reference trains ZeRO-3 through GSPMD (`default_rules` maps `fsdp` to
the DP axes); its own sharded-train test fails under jax 0.9.0, so the
port's step is held to `jax.value_and_grad` of the reference's `loss_fn`
and to the port's meshless step.  4 gloo ranks on the CPU, spawned once
for the file (`_torch_parallel_ranks.zero_train_rank`), form "data=2" on
ranks 0 and 1 and "data=2,model=2" on all four, and train granite-8b's
smoke config, float and QAT 8/8, on each:
  * one step's loss within ATOL_LOSS and every gradient, gathered to
    whole leaves, within RTOL_GRAD of each leaf's largest
    (`test_torch_train.py`'s tolerances: f32 reassociation of the rank
    sums and means);
  * two AdamW updates with grad_clip 1e9 (so the clip factor is exactly
    1) on those gradients: params, the int8 m's blocks and scales and v,
    gathered, equal the meshless `adamw.apply` bit for bit;
  * each rank's bytes of params, m and v: its block of every leaf the
    reference's rules cut (`spec_for`, `default_rules`, a dim cut only
    where the axis size divides it), the whole leaf elsewhere;
  * the collectives of a step, by kind, as derived below;
  * the Trainer's 3-step history within ATOL_HIST of the meshless and JAX
    Trainers', and recovery from a failure injected on every rank equal
    to the uninterrupted run bit for bit;
  * checkpoints restore bit for bit meshless <-> data=2 <-> data=2,model=2
    and into the reference's `ckpt.restore` (the port's form of the
    reference's elastic-mesh test, `tests/test_distributed.py`).
On data=2 alone, one step of the smoke configs of qwen3-moe-30b-a3b,
minicpm3-4b, xlstm-1.3b and jamba-1.5-large-398b (MoE experts, MLA and
the recurrent mixers' `fsdp` cuts) against `jax.value_and_grad`, and of
the other five archs against the port's meshless step.  A last
test shows that the loss tolerance tells the port's QAT forward, which
quantizes the gathered weight, from one that quantizes each rank's block.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import zero_train_rank
from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import quant
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.runtime.trainer import Trainer, TrainerConfig, TrainLayout
from repro_torch.tree import tree_items, tree_map, tree_map_with_path
from test_torch_convert import smoke_pair, to_torch
from test_torch_tp_trainer import _bits, _state_np, _to_jax
from test_torch_train import ATOL_LOSS, RTOL_GRAD, _batch
from test_torch_trainer import ATOL_HIST

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

WORLD = 4
MESHES = {"data=2": {"data": 2, "model": 1},
          "data=2,model=2": {"data": 2, "model": 2}}
BITS = {"fp": 0, "q8": 8}
ARCHS = ("qwen3-moe-30b-a3b", "minicpm3-4b", "xlstm-1.3b",
         "jamba-1.5-large-398b")
# the rest of the archs that train, held to the port's meshless step
OTHERS = ("dbrx-132b", "internlm2-20b", "starcoder2-7b",
          "llama-3.2-vision-11b", "musicgen-large")
ADAMW = adamw.AdamWConfig(lr=1e-2, grad_clip=1e9)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_grads(jc, jp, batch):
    """(loss, {path: gradient}) of `jax.value_and_grad(loss_fn)`."""
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jc), has_aux=True))(jp)
    return float(jl), {k: v.numpy() for k, v in tree_items(to_torch(jg))}


def _meshless(tc, params, batch):
    """(loss, {path: gradient}) of the port's meshless step."""
    local = tree_map(lambda t: t.clone().requires_grad_(True), params)
    g, loss, _ = TrainLayout(tc).grads(local, _torch_batch(batch))
    return float(loss), {k: v.numpy() for k, v in tree_items(g)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The ranks' inputs and outputs.  Step cases: smoke granite from the
    port's seeded params (the JAX package's are the same numbers), a batch
    of 4 rows of 8 tokens; the other archs from the JAX package's params.
    The Trainer: the float smoke config from the same params, SyntheticLM
    batches of 2 x 16, and a meshless Trainer's one-step checkpoint for
    the ranks to restore."""
    steps, ref = {}, {}
    jc, tc = smoke_pair("granite-8b")
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = _to_jax(params)
    for name, bits in BITS.items():
        jc, tc = smoke_pair("granite-8b", **({"quant_bits": bits}
                                             if bits else {}))
        batch = _batch(jc, B=4, S=8)
        steps[name] = (tc, params, _torch_batch(batch))
        ref[name] = (jc, jp, batch)
    archs = {}
    for arch in ARCHS:
        jc, tc = smoke_pair(arch)
        ajp = JM.init_params(jc, jax.random.PRNGKey(0))
        batch = _batch(jc, B=4, S=8)
        archs[arch] = (tc, to_torch(ajp), _torch_batch(batch))
        ref[arch] = (jc, ajp, batch)
    for arch in OTHERS:
        jc, tc = smoke_pair(arch)
        archs[arch] = (tc, TM.init_params(tc, torch.Generator().manual_seed(
            0), "cpu"), _torch_batch(_batch(jc, B=4, S=8)))
    jc, tc = smoke_pair("granite-8b")
    batches = [SyntheticLM(DataConfig(tc.vocab_size, 16, 2)).batch(i)
               for i in range(3)]
    dirs = {m: {k: str(tmp_path_factory.mktemp(f"{m}_{k}".replace(
        "=", "").replace(",", "_"))) for k in ("history", "plain", "crash")}
        for m in MESHES}
    meshless_dir = str(tmp_path_factory.mktemp("meshless"))
    for d in dirs.values():
        d["meshless"] = meshless_dir
    meshless = Trainer(tc, TrainerConfig(
        ckpt_dir=meshless_dir, async_ckpt=False,
        opt=adamw.AdamWConfig(lr=1e-3)), tree_map(torch.clone, params))
    meshless.run_step(batches[0])
    meshless.maybe_checkpoint(force=True)
    outs = comm.spawn(zero_train_rank, WORLD, steps, archs,
                      (tc, params, batches, dirs), device="cpu")
    # every rank of a mesh holds the same loss and the same whole leaves
    for mesh in MESHES:
        ranks = [o[mesh] for o in outs if mesh in o]
        assert len(ranks) == (2 if mesh == "data=2" else 4)
        for o in ranks[1:]:
            for name in BITS:
                assert o[name]["loss"] == ranks[0][name]["loss"]
                for k, v in ranks[0][name]["state"].items():
                    np.testing.assert_array_equal(o[name]["state"][k], v)
    return {"steps": steps, "ref": ref, "archs": archs, "out": outs,
            "jp": jp,
            "trainer": (tc, params, batches, dirs),
            "meshless": _state_np(meshless.state_tree())}


@pytest.mark.parametrize("name", list(BITS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_step_loss_and_grads_equal_jax_and_meshless(case, mesh, name):
    """The loss and every gradient of one ZeRO-3 step, gathered to whole
    leaves, against `jax.value_and_grad(loss_fn)` on the same params and
    batch and against the port's meshless step."""
    jl, jg = _jax_grads(*case["ref"][name])
    ml, mg = _meshless(*case["steps"][name][:2], case["ref"][name][2])
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


@pytest.mark.parametrize("name", list(BITS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_adamw_equals_meshless_bit_for_bit(case, mesh, name):
    """Two AdamW updates of each rank's blocks with the step's gradients
    (grad_clip 1e9: clip is 1) equal the meshless `adamw.apply` of the
    whole gradients: params, m's int8 blocks and f32 scales, v, bit for
    bit."""
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


def _reference_block(path: str, shape, sizes: dict) -> tuple:
    """The block of a param of `shape` at `path` (keys joined by "/") one
    rank holds under the reference's training rules on a mesh of `sizes`:
    each dim its `spec_for` names `fsdp` or `tp` divided by the axis size
    where that divides it (`param_shardings`); the port keeps the
    embedding whole on `model` (`sharding.SERVE_WHOLE`)."""
    rules = jshd.default_rules(multi_pod=False)
    spec = jshd.spec_for(path.replace("/", "."), len(shape))
    out = list(shape)
    for d, name in enumerate(spec):
        if name is None or (name == "tp" and path.endswith("embedding")):
            continue
        ax = rules[name]
        n = math.prod(sizes[a] for a in ((ax,) if isinstance(ax, str)
                                         else ax))
        if shape[d] % n == 0:
            out[d] //= n
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_rank_holds_its_block_of_params_m_and_v(case, mesh):
    """Each rank's bytes of every param and of its v: its block of the
    leaf under the reference's rules (1/n along each cut dim, the whole
    leaf where no rule cuts it or n does not divide); its int8 m: the
    blocks of those values, ceil(block / 128) rows of 128, with the block
    scales of its own blocks, or of the whole leaf where its 128-blocks
    span ranks (`optim.adamw`).  The large leaves are all cut."""
    tc, params, _ = case["steps"]["fp"]
    got = case["out"][0][mesh]["fp"]["nbytes"]
    cut = 0
    for path, t in tree_items(params):
        block = _reference_block(path, tuple(t.shape), MESHES[mesh])
        n = math.prod(block)
        assert got[f"params/{path}"] == n * t.element_size(), path
        assert got[f"opt/v/{path}"] == n * 2, path
        assert got[f"opt/m/{path}/0"] == -(-n // 128) * 128, path
        last = max((d for d in range(t.ndim) if block[d] != t.shape[d]),
                   default=None)
        run = None if last is None else \
            block[last] * math.prod(t.shape[last + 1:])
        scales = n // 128 if run is not None and run % 128 == 0 \
            else -(-t.numel() // 128)
        assert got[f"opt/m/{path}/1"] == scales * 4, path
        cut += n < t.numel()
        if t.numel() >= 4096:
            assert n < t.numel(), path
    assert cut == 7 + 2          # the stacked linears, embedding, unembed


def _collectives(tc, name: str, mesh: str) -> tuple[dict, dict]:
    """Per rank, the step's and two AdamW updates' collectives, derived.
    ZeRO-3 over `data`: each layer's 7 linears, the embedding and the
    unembed are gathered once forward, each whose weight autograd saves
    (all but the embedding: its lookup saves the indices) once more in
    backward, and each gradient of theirs reduce-scattered; one mean of
    the loss and the gradients of the leaves left whole (the norms).
    Under `model` too: each layer's wo and w_down take (QAT) max x, max w
    and the int32 sum, or (float) one sum, the logits one gather, and
    backward one gradient sum at the input of each attention, MLP and the
    unembed.  AdamW's norm takes one sum an axis, and the blocks that
    span ranks (wo's and w_down's 32 of 64 columns, the embedding's) one
    max an axis."""
    L, axes = tc.num_layers, len([n for n in MESHES[mesh].values() if n > 1])
    step = {"all-gather": (7 * L + 2) + (7 * L + 1),
            "reduce-scatter": 7 * L + 2, "all-reduce": 1}
    if MESHES[mesh]["model"] > 1:
        per_row = 3 if BITS[name] else 1
        step["all-gather"] += 1
        step["all-reduce"] += L * 2 * per_row + L * 2 + 1
    return step, {"all-reduce": 2 * (axes + axes)}


@pytest.mark.parametrize("name", list(BITS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_collectives_per_step_as_derived(case, mesh, name):
    tc = case["steps"][name][0]
    got = case["out"][0][mesh][name]
    step, opt = _collectives(tc, name, mesh)
    assert got["grad_calls"] == step
    assert got["adamw_calls"] == opt


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_trainer_history_equals_meshless_and_jax(case, tmp_path, mesh):
    """Three `run_step`s of the float smoke config: loss and grad norm
    within ATOL_HIST of the meshless Trainer's and the JAX Trainer's from
    the same params and zero AdamW state."""
    tc, params, batches, _ = case["trainer"]
    jc, _ = smoke_pair("granite-8b")
    jp = _to_jax(params)                 # a copy: the JAX step donates it
    ocfg = dict(lr=1e-3)
    jt = JTrainer(jc, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                     opt=jadamw.AdamWConfig(**ocfg)), jp,
                  jadamw.init(jp, jadamw.AdamWConfig(**ocfg)))
    tt = Trainer(tc, TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                   opt=adamw.AdamWConfig(**ocfg)),
                 tree_map(torch.clone, params))
    jpipe = JSyntheticLM(JDataConfig(jc.vocab_size, seq_len=16,
                                     global_batch=2))
    got = case["out"][0][mesh]["trainer"]["history"]
    assert len(got) == 3
    for step, b in enumerate(batches):
        jm, tm = jt.run_step(jpipe.batch(step)), tt.run_step(b)
        for k in ("loss", "grad_norm"):
            for want in (jm[k], tm[k]):
                np.testing.assert_allclose(got[step][k], want,
                                           rtol=ATOL_HIST, atol=ATOL_HIST,
                                           err_msg=f"{step} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_recovery_equals_uninterrupted(case, mesh):
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


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_checkpoints_restore_across_meshes(case, mesh):
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
    other = next(m for m in MESHES if m != mesh)
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


def test_collectives_in_lanes_equal_the_written_out_results(case):
    """Collectives past `comm.LANE_BYTES` run in lanes (set to 4 KiB here;
    4 MiB by default, so the smoke steps run in one): all-gathers,
    reduce-scatters and max all-reduces over both axes of data=2,model=2
    on odd shapes (the last span short or empty), each equal bit for bit
    to the result written out from every rank's inputs."""
    for o in case["out"]:
        assert o["lanes"] and all(o["lanes"].values()), \
            [k for k, v in o["lanes"].items() if not v]


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_step_of_each_layer_kind_equals_jax(case, arch):
    """One step on data=2 of the MoE (experts cut on d), MLA, mamba, mLSTM
    and sLSTM smoke configs: loss within ATOL_LOSS and every gathered
    gradient within RTOL_GRAD of `jax.value_and_grad`, the MoE layers
    routing the whole batch as the reference does; every saved gathered
    weight gathered again in backward."""
    jc, _, _ = case["ref"][arch]
    jl, jg = _jax_grads(*case["ref"][arch])
    got = case["out"][0]["data=2"][arch]
    assert abs(got["loss"] - jl) <= ATOL_LOSS * max(1, abs(jl))
    # each gathered leaf and MoE input reduce-scatters its gradient once;
    # each gathered leaf but the embedding is gathered again in backward
    # (a saved weight is never kept whole), a MoE input is not
    calls = got["grad_calls"]
    moe = sum(s.endswith("+moe") for s in jc.layer_pattern) * jc.n_periods
    assert calls["reduce-scatter"] > 0
    assert calls["all-gather"] == 2 * calls["reduce-scatter"] - 1 - moe
    for path, want in jg.items():
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got["grads"][path], want, rtol=0,
                                   atol=RTOL_GRAD * scale, err_msg=path)


@pytest.mark.parametrize("arch", OTHERS)
def test_zero_step_of_every_other_arch_equals_meshless(case, arch):
    """Every other arch that trains keeps training on data=2 (the 16-expert
    MoE, GQA variants, cross-attention over vision embeddings split by
    rows, the audio frontend's frame embeddings): loss within ATOL_LOSS
    and every gathered gradient within RTOL_GRAD of the port's meshless
    step on the same params and batch."""
    tc, params, batch = case["archs"][arch]
    local = tree_map(lambda t: t.clone().requires_grad_(True), params)
    g, loss, _ = TrainLayout(tc).grads(local, batch)
    got = case["out"][0]["data=2"][arch]
    assert abs(got["loss"] - float(loss)) <= ATOL_LOSS * max(
        1, abs(float(loss)))
    for path, want in tree_items(g):
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(got["grads"][path], want.numpy(), rtol=0,
                                   atol=RTOL_GRAD * scale, err_msg=path)


# the names whose `fsdp` dim is a linear's contraction dim K (the reference's
# `spec_for` puts it on dim -2): quantizing a rank's block of such a weight
# gives per-column scales over K/n rows instead of K
_K_CUT = re.compile(r"(wq|wk|wv|w_gate|w_up|unembed)$")


def _shard_quantized_dense(n: int, kcut):
    """`ops.bramac_dense` as a forward that quantized each rank's block of
    a K-cut weight (the `n` blocks of K, each with its own per-column
    scales) would compute: the activations per row over the whole K, the
    products of the blocks summed."""
    real = ops.bramac_dense

    def dense(x, w, bits_w, bits_a):
        if not any(w is k or w._base is k for k in kcut):
            return real(x, w, bits_w, bits_a)
        x2 = x.reshape(-1, x.shape[-1])
        qx = quant.quantize(x2, bits_a, axis=-1)
        y = 0
        for xb, wb in zip(qx.values.chunk(n, -1), w.chunk(n, 0)):
            qw = quant.quantize(wb, bits_w, axis=0)
            y = y + ops.quant_matmul(xb, qw.values, qx.scale, qw.scale,
                                     bits_a=bits_a, bits_w=bits_w)
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])
    return dense


def test_qat_forward_quantizes_the_gathered_weight(case, monkeypatch):
    """The QAT step on data=2 has the meshless loss within ATOL_LOSS,
    while a forward that quantized each rank's block of the K-cut weights
    (wq, wk, wv, w_gate, w_up, the unembed: per-column scales over K/2)
    misses it by more than that tolerance: the loss test would catch a
    shard-quantizing forward."""
    tc, params, batch = case["steps"]["q8"]
    with torch.no_grad():
        want = float(TM.loss_fn(params, batch, tc)[0])
        kcut = [t for k, t in tree_items(params) if _K_CUT.search(k)]
        monkeypatch.setattr(ops, "bramac_dense",
                            _shard_quantized_dense(2, kcut))
        shard = float(TM.loss_fn(params, batch, tc)[0])
    tol = ATOL_LOSS * max(1, abs(want))
    got = case["out"][0]["data=2"]["q8"]["loss"]
    assert abs(got - want) <= tol
    assert abs(shard - want) > tol, (shard, want)
