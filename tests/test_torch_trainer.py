"""The port's fault-tolerant Trainer (`runtime.trainer`) and training
launcher (`launch.train`) against the JAX package's.

From the same converted params and AdamW state (`convert.from_jax_tree`
carries the Q8 moments field by field and `step` as an int32 scalar), a
granite smoke run's loss history equals the JAX Trainer's within
ATOL_HIST (f32 reassociation compounding over the steps; with QAT the
first step within ATOL_HIST and the later ones within ATOL_HIST_QAT).
Failure recovery follows tests/test_substrates.py's scheme, and on the CPU
the recovered history and final state equal an uninterrupted run's bit
for bit; the straggler watchdog logs a slow step by its index; the
launcher's closing line reads as the reference launcher's."""
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import ckpt
from repro_torch.convert import from_jax_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items, tree_leaves
from test_torch_convert import REPO, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

ATOL_HIST = 1e-4
# QAT: after the first update the params differ in their last bits, and a
# fake-quant rounding that lands on the other side of a level moves the
# loss by ~1e-3 (one 8-bit step of one activation row)
ATOL_HIST_QAT = 5e-3


@pytest.mark.parametrize("bits", [0, 8])
def test_trainer_history_equals_jax(tmp_path, bits):
    """Four `run_step`s of the granite smoke config (float, and QAT 8/8) on
    SyntheticLM batches, from the JAX params and the JAX AdamW state
    (int8 m / bf16 v) carried into the port: loss, ce and grad norm of
    every step against the JAX Trainer's."""
    jc, tc = smoke_pair("granite-8b", **({"quant_bits": bits} if bits
                                         else {}))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    ocfg = dict(lr=1e-3)
    js = jadamw.init(jp, jadamw.AdamWConfig(**ocfg))
    tp = to_torch(jp)
    ts = from_jax_tree(jax.tree_util.tree_map(np.asarray, js))
    assert isinstance(ts["m"]["embed"]["unembed"], tadamw.Q8)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    jt = JTrainer(jc, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                     opt=jadamw.AdamWConfig(**ocfg)), jp, js)
    tt = Trainer(tc, TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                   opt=tadamw.AdamWConfig(**ocfg)), tp, ts)
    jpipe = JSyntheticLM(JDataConfig(jc.vocab_size, seq_len=16,
                                     global_batch=2))
    tpipe = SyntheticLM(DataConfig(tc.vocab_size, seq_len=16, global_batch=2))
    for step in range(4):
        jm = jt.run_step(jpipe.batch(step))
        tm = tt.run_step(tpipe.batch(step))
        tol = ATOL_HIST_QAT if bits and step else ATOL_HIST
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=tol, atol=tol,
                                       err_msg=f"{step} {k}")
    assert tt.step == jt.step == 4 and int(tt.opt_state["step"]) == 4
    assert all(p.grad is None for p in tree_leaves(tt.params))


def _state(tree):
    """The tensors of a {params, opt} tree, Q8 moments as (q, scale)."""
    return [t.detach() for _, t in tree_items(tree)]


def _smoke_trainer(d, **kw):
    _, tc = smoke_pair("granite-8b")
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    return tc, Trainer(tc, TrainerConfig(
        ckpt_dir=str(d), opt=tadamw.AdamWConfig(lr=1e-3), **kw), params)


def test_trainer_failure_recovery_equals_uninterrupted(tmp_path):
    """tests/test_substrates.py's scheme: checkpoints every 2 steps, a
    failure injected at step 5 rolls back to step 4 and replays; the history
    after recovery and the final state equal an uninterrupted run's bit for
    bit, and the final checkpoint is step 8 (async saves, keep 3)."""
    tc, t0 = _smoke_trainer(tmp_path / "a", ckpt_every=2)
    pipe = SyntheticLM(DataConfig(tc.vocab_size, seq_len=16, global_batch=2))
    h0 = t0.train(pipe, num_steps=8)
    _, t1 = _smoke_trainer(tmp_path / "b", ckpt_every=2)
    crashed = []

    def failure_hook(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")

    h1 = t1.train(pipe, num_steps=8, failure_hook=failure_hook)
    assert crashed == [5] and t1.step == 8 and len(h1) == 9
    assert h1[:5] == h0[:5] and h1[5:] == h0[4:]
    assert all(np.isfinite(h["loss"]) for h in h1)
    s0, s1 = _state(t0.state_tree()), _state(t1.state_tree())
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert ckpt.latest_step(str(tmp_path / "b")) == 8
    assert sorted(os.listdir(tmp_path / "b")) == [
        "step_00000004", "step_00000006", "step_00000008"]
    back = ckpt.restore(str(tmp_path / "b"), 8, t1.state_tree())
    assert all(torch.equal(a, b) for a, b in zip(s1, _state(back)))


def test_trainer_gives_up_after_max_restarts(tmp_path):
    tc, tr = _smoke_trainer(tmp_path, ckpt_every=2)
    pipe = SyntheticLM(DataConfig(tc.vocab_size, seq_len=8, global_batch=2))

    def always(step):
        if step == 3:
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        tr.train(pipe, num_steps=6, failure_hook=always, max_restarts=2)


def test_trainer_straggler_watchdog(tmp_path):
    """A step that takes more than straggler_factor x the EWMA (after the
    first 4) is logged with its index; the EWMA keeps being updated."""
    tc, tr = _smoke_trainer(tmp_path, ckpt_every=100, straggler_factor=2.0,
                            async_ckpt=False)
    pipe = SyntheticLM(DataConfig(tc.vocab_size, seq_len=16, global_batch=2))
    real = tr._train_step

    def slow(batch):
        if tr.step == 5:
            time.sleep(max(1.0, 10 * tr._ewma))
        return real(batch)

    tr._train_step = slow
    for step in range(7):
        tr.run_step(pipe.batch(step))
    assert [s for s, _ in tr.straggler_events] == [5]
    assert tr._ewma is not None and tr._ewma > 0


def _run(mod, args, tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", mod, "--arch", "granite-8b", "--smoke",
         "--steps", "3", "--seq", "16", "--batch", "2", "--quant-bits", "8",
         "--ckpt-dir", str(tmp)] + args, env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    return out


def test_launcher_closing_line_as_the_reference(tmp_path):
    """`--smoke --device cpu` prints the reference launcher's closing line
    (`loss a -> b over n steps; straggler events: k`) over the same number
    of steps, and writes its final checkpoint; a second run resumes from
    it and takes no step.  `--model 2` trains tensor-parallel on 2 ranks
    and prints the same closing line, and so does qwen3-moe (its experts
    split over the ranks) and jamba (mamba, attention and MoE layers:
    refused before tensor-parallel training of the mixers was ported);
    --data is tests/test_torch_dp_trainer.py's."""
    ref = _run("repro.launch.train", [], tmp_path / "j")
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = _run("repro_torch.launch.train", ["--device", "cpu"],
               tmp_path / "t")
    assert got.returncode == 0, got.stderr[-3000:]
    pat = re.compile(r"^loss (\d+\.\d{4}) -> (\d+\.\d{4}) over (\d+) steps; "
                     r"straggler events: (\d+)$")
    rl, tl = ref.stdout.strip().splitlines(), got.stdout.strip().splitlines()
    mr, mt = pat.match(rl[-1]), pat.match(tl[-1])
    assert mr and mt, (rl[-1], tl[-1])
    assert mr.group(3) == mt.group(3) == "3"
    assert tl[0].startswith("device cpu  arch granite-8b-smoke  params ")
    assert tl[0].split("params ")[1] == rl[0].split("params ")[1]
    assert ckpt.latest_step(str(tmp_path / "t")) == 3
    again = _run("repro_torch.launch.train", ["--device", "cpu"],
                 tmp_path / "t")
    assert again.returncode == 0 and len(
        again.stdout.strip().splitlines()) == 1
    mesh = _run("repro_torch.launch.train", ["--device", "cpu", "--model",
                                             "2"], tmp_path / "m")
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    ml = mesh.stdout.strip().splitlines()
    assert ml[0].startswith("mesh {'data': 1, 'model': 2}  device cpu  arch "
                            "granite-8b-smoke  params ")
    mm = pat.match(ml[-1])
    assert mm and mm.group(3) == "3", ml[-1]
    assert ckpt.latest_step(str(tmp_path / "m")) == 3
    moe = _run("repro_torch.launch.train", ["--device", "cpu", "--model",
                                            "2", "--arch",
                                            "qwen3-moe-30b-a3b"],
               tmp_path / "q")
    assert moe.returncode == 0, moe.stderr[-3000:]
    ql = moe.stdout.strip().splitlines()
    assert ql[0].startswith("mesh {'data': 1, 'model': 2}  device cpu  arch "
                            "qwen3-moe-30b-a3b-smoke  params ")
    mq = pat.match(ql[-1])
    assert mq and mq.group(3) == "3", ql[-1]
    assert ckpt.latest_step(str(tmp_path / "q")) == 3
    hybrid = _run("repro_torch.launch.train", ["--device", "cpu", "--model",
                                               "2", "--arch",
                                               "jamba-1.5-large-398b"],
                  tmp_path / "h")
    assert hybrid.returncode == 0, hybrid.stderr[-3000:]
    hl = hybrid.stdout.strip().splitlines()
    assert hl[0].startswith("mesh {'data': 1, 'model': 2}  device cpu  arch "
                            "jamba-1.5-large-398b-smoke  params ")
    mh = pat.match(hl[-1])
    assert mh and mh.group(3) == "3", hl[-1]
    assert ckpt.latest_step(str(tmp_path / "h")) == 3
