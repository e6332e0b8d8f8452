"""The port's data-parallel trainer (`runtime.dp_trainer`, the Trainer's
`data` axis) and `launch/train.py --data`, against the JAX package's.

`compress_decompress` equals the reference's (int8 blocks of 256 with
error feedback) on the same gradient.  The ranks run on 2 gloo ranks on
the CPU, spawned once for the file (`_torch_parallel_ranks.dp_rank`), on
the reference's toy problem (a (16, 4) regression, a batch of 64 over a
2-way `data` axis): one compressed step equals the composition of JAX's
`compress_decompress` over the per-shard gradients within FP_ATOL (f32
reassociation of the shard means), is close to the exact step (relative
error < 0.05, the reference's bound), and 200 steps of each converge as
the reference's test asserts.  The Trainer on the same 2 ranks restores a
checkpoint written without a mesh and takes two steps whose losses and
weights match a meshless Trainer's within the stated tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import dp_rank
from repro.runtime import dp_trainer as jdp
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.runtime import dp_trainer as tdp
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items
from test_torch_convert import np_, smoke_pair

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

WORLD = 2
FP_ATOL = 1e-5
# the Trainer: shard-mean vs full-batch loss and gradients differ in f32
# reassociation; AdamW's int8 first moment can turn that into one
# quantization step of m, moving a weight by a few lr-sized updates
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4



def _seeded(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# the reference's toy problem: params, target, batch
TOY = ({"w": _seeded((16, 4), 0)}, _seeded((16, 4), 1),
       _seeded((64, 16), 2))


def _toy_loss(p, batch):
    target = jnp.asarray(TOY[1].numpy())
    return jnp.mean((batch @ p["w"] - batch @ target) ** 2)


@pytest.fixture(scope="module")
def trainer_case(tmp_path_factory):
    """granite smoke, one meshless step then a checkpoint; the two batches
    the ranks and the meshless continuation both take next."""
    _, cfg = smoke_pair()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pipe = SyntheticLM(DataConfig(cfg.vocab_size, 16, 8))
    ckpt_dir = str(tmp_path_factory.mktemp("dp_ckpt"))
    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=1000,
                         async_ckpt=False, opt=adamw.AdamWConfig(lr=1e-3))
    first = Trainer(cfg, tcfg, params)
    first.run_step(pipe.batch(0))
    first.maybe_checkpoint(force=True)
    batches = [pipe.batch(i) for i in (1, 2)]
    meshless = Trainer(cfg, tcfg, TM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert meshless.restore_latest() == 1
    want = [meshless.run_step(b)["loss"] for b in batches]
    fresh = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return (cfg, fresh, batches, ckpt_dir), want, \
        {k: np_(v) for k, v in tree_items(meshless.params)}


@pytest.fixture(scope="module")
def ranks(trainer_case):
    outs = comm.spawn(dp_rank, WORLD, TOY, trainer_case[0], device="cpu")
    for other in outs[1:]:
        np.testing.assert_array_equal(other["g1"], outs[0]["g1"])
        assert other["finals"] == outs[0]["finals"]
        for k, v in outs[0]["trainer"]["params"].items():
            np.testing.assert_array_equal(other["trainer"]["params"][k], v)
    return outs


@pytest.mark.parametrize("size", [1000, 256, 7])
def test_compress_decompress_equals_jax(size):
    """One error-feedback round (int8 blocks of 256, the last padded):
    g_hat and the new residual equal the reference's bit for bit."""
    rng = np.random.default_rng(size)
    g = rng.normal(size=(size,)).astype(np.float32)
    e = (rng.normal(size=(size,)) * 1e-3).astype(np.float32)
    jg, je = jdp.compress_decompress(jnp.asarray(g), jnp.asarray(e))
    tg, te = tdp.compress_decompress(torch.from_numpy(g),
                                     torch.from_numpy(e))
    np.testing.assert_array_equal(np_(tg), np.asarray(jg))
    np.testing.assert_array_equal(np_(te), np.asarray(je))


def test_compressed_step_equals_jax_per_shard(ranks):
    """The compressed step's gradient == the mean over the 2 shards of
    JAX's `compress_decompress` of each shard's gradient (zero residual),
    and its residual is this rank's shard's; the loss is the shard mean."""
    params, _, batch = TOY
    w = jnp.asarray(params["w"].numpy())
    shards = np.split(batch.numpy(), WORLD)
    hats, errs, losses = [], [], []
    for s in shards:
        loss, g = jax.value_and_grad(_toy_loss)({"w": w}, jnp.asarray(s))
        gh, e = jdp.compress_decompress(g["w"], jnp.zeros_like(g["w"]))
        hats.append(np.asarray(gh))
        errs.append(np.asarray(e))
        losses.append(float(loss))
    np.testing.assert_allclose(ranks[0]["g1"], np.mean(hats, 0), rtol=0,
                               atol=FP_ATOL)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["err1"], errs[r], rtol=0,
                                   atol=FP_ATOL)
    np.testing.assert_allclose(ranks[0]["l1"], np.mean(losses), rtol=1e-6)


def test_dp_compression_and_convergence(ranks):
    """int8+error-feedback grads are close to the exact mean grads after one
    step, and 200 steps of each descend >100x and end within 5% of each
    other (the reference's test on 8 shards; 2 here)."""
    out = ranks[0]
    params, _, batch = TOY
    loss0, g = jax.value_and_grad(_toy_loss)(
        {"w": jnp.asarray(params["w"].numpy())}, jnp.asarray(batch.numpy()))
    np.testing.assert_allclose(out["g0"], np.asarray(g["w"]), rtol=0,
                               atol=FP_ATOL)
    rel = np.linalg.norm(out["g1"] - out["g0"]) / np.linalg.norm(out["g0"])
    assert rel < 0.05, rel
    f_comp, f_exact = out["finals"]
    assert f_comp < 0.01 * float(loss0)
    assert abs(f_comp - f_exact) < 0.05 * f_exact + 1e-6


def test_trainer_data_parallel_matches_meshless(ranks, trainer_case):
    """The Trainer on a 2-way `data` axis restores the checkpoint a
    meshless Trainer wrote (the same tree on every mesh), then two steps:
    losses within LOSS_RTOL and weights within PARAM_ATOL of the meshless
    Trainer's, identical on every rank."""
    _, want, want_params = trainer_case
    got = ranks[0]["trainer"]
    assert got["restored"] == 1
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    assert got["params"].keys() == want_params.keys()
    for k, v in want_params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_launcher_data_parallel_on_the_cpu(tmp_path, capfd):
    """`--data 2` spawns 2 ranks; rank 0 prints the mesh and the
    reference's closing line (to this process's stdout) and writes the
    checkpoint; `--model 2` raises NotImplementedError naming the ROADMAP
    item."""
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--steps",
            "3", "--ckpt-dir", str(tmp_path)]
    tlaunch.main(args + ["--data", "2"])
    lines = capfd.readouterr().out.strip().splitlines()
    assert lines[0].startswith(
        "mesh {'data': 2, 'model': 1}  device cpu  arch granite-8b-smoke")
    assert lines[-1].startswith("loss ") and lines[-1].endswith(
        "over 3 steps; straggler events: 0")
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tlaunch.main(args + ["--model", "2"])
