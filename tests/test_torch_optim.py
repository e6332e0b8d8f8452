"""The port's training substrates against the JAX package's on the same
numpy inputs: AdamW (`optim.adamw`, with and without int8 moments), the
synthetic data pipeline (`data.pipeline`) and checkpoints
(`checkpoint.ckpt`), whose files each package reads from the other.

Bit for bit: `_q8` / `_dq8`, `init`, the SyntheticLM batches, every
checkpoint round trip and cross-read, and the port's slice-wise update
against its own whole-leaf update.  Within a tolerance: AdamW over several
steps (ATOL_PARAM: XLA fuses the update into other roundings of the same
f32 expressions; the int8 first moment follows within one quantization
step of its block, ATOL_Q8 of the block's largest value) and
`lr_schedule` (f32, rtol 1e-6)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_items, tree_leaves
from test_torch_convert import np_, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

ATOL_PARAM = 1e-6
ATOL_Q8 = 1.0 / 127


def _toy(seed, dtype=np.float32):
    """A tree with a stacked 3-D leaf, a vector (no decay) and a matrix
    whose size is not a multiple of the 128-value block."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(3, 64, 40)).astype(dtype)},
            "b": rng.normal(size=(37,)).astype(dtype),
            "c": rng.normal(size=(300, 7)).astype(dtype)}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), t)


def test_q8_roundtrip_bit_equal_to_jax():
    x = (np.random.default_rng(0).normal(size=(1000,)) * 3).astype(np.float32)
    jq = jadamw._q8(jnp.asarray(x))
    tq = tadamw._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(np_(tq.q), np.asarray(jq.q))
    np.testing.assert_array_equal(np_(tq.scale), np.asarray(jq.scale))
    np.testing.assert_array_equal(np_(tadamw._dq8(tq)),
                                  np.asarray(jadamw._dq8(jq)))
    assert tq.shape == jq.shape == (1000,)


@pytest.mark.parametrize("quantized", [False, True])
def test_init_equals_jax(quantized):
    """Zero moments built without f32 temporaries equal the reference's
    (a Q8 of zeros: int8 zeros, every scale at the 1e-12 floor)."""
    p = _toy(0)
    cfg = dict(quantize_state=quantized)
    js = jadamw.init(_jtree(p), jadamw.AdamWConfig(**cfg))
    ts = tadamw.init(_ttree(p), tadamw.AdamWConfig(**cfg))
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    jl = jax.tree_util.tree_leaves(js)
    tl = [t for k in ("m", "step", "v") for _, t in tree_items(ts[k])]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np_(b.float()))


@pytest.mark.parametrize("quantized", [False, True])
def test_apply_equals_jax_over_steps(quantized):
    """Five steps with clipping active, decay on matrices only: params and
    the dequantized moments against the reference's, and the grad norm."""
    cfg = dict(lr=0.01, quantize_state=quantized, grad_clip=5.0)
    p = _toy(0)
    jp, tp = _jtree(p), _ttree(p)
    js = jadamw.init(jp, jadamw.AdamWConfig(**cfg))
    ts = tadamw.init(tp, tadamw.AdamWConfig(**cfg))
    for step in range(5):
        g = _toy(10 + step)
        jp, js, jm = jadamw.apply(jp, js, _jtree(g), jadamw.AdamWConfig(**cfg))
        _, _, tm = tadamw.apply(tp, ts, _ttree(g), tadamw.AdamWConfig(**cfg))
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(tree_leaves(jax.tree_util.tree_map(np.asarray, jp)),
                    tree_leaves(tp)):
        np.testing.assert_allclose(np_(b), a, rtol=0, atol=ATOL_PARAM)
    if quantized:
        jm_ = jax.tree_util.tree_map(np.asarray, jadamw._dqtree(js["m"]))
        tm_ = jax.tree_util.tree_map(
            lambda q: tadamw._dq8(q), ts["m"],
            is_leaf=lambda x: isinstance(x, tadamw.Q8))
        for a, b in zip(tree_leaves(jm_), tree_leaves(tm_)):
            np.testing.assert_allclose(np_(b), a, rtol=0,
                                       atol=ATOL_Q8 * np.abs(a).max())
        for a, b in zip(tree_leaves(jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32), js["v"])),
                tree_leaves(ts["v"])):
            assert b.dtype == torch.bfloat16
            np.testing.assert_allclose(np_(b.float()), a, rtol=2 ** -7,
                                       atol=1e-12)


@pytest.mark.parametrize("quantized", [False, True])
def test_slicewise_update_equals_whole_leaf(quantized, monkeypatch):
    """The in-place update in slices of 256 values (block boundaries inside
    every leaf) and in one slice per leaf give the same params and state
    bit for bit, step after step."""
    cfg = tadamw.AdamWConfig(lr=0.01, quantize_state=quantized)
    p = _toy(3)
    whole, sliced = _ttree(p), _ttree(p)
    sw, ss = tadamw.init(whole, cfg), tadamw.init(sliced, cfg)
    for step in range(3):
        g = _ttree(_toy(20 + step))
        monkeypatch.setattr(tadamw, "SLICE_ELEMS", 128 << 20)
        tadamw.apply(whole, sw, g, cfg)
        monkeypatch.setattr(tadamw, "SLICE_ELEMS", 256)
        tadamw.apply(sliced, ss, g, cfg)
    for a, b in zip(tree_leaves(whole), tree_leaves(sliced)):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        for (ka, a), (kb, b) in zip(tree_items(sw[k]), tree_items(ss[k])):
            assert ka == kb and torch.equal(a, b)


def test_apply_bf16_params_equal_jax():
    """bf16 params and grads (the full-width training dtype), int8 m / bf16
    v: three steps, params equal to the reference's within one bf16 ulp."""
    import ml_dtypes
    p = _toy(4, ml_dtypes.bfloat16)
    jp = _jtree(p)
    tp = to_torch(p)
    cfg = dict(lr=0.01)
    js = jadamw.init(jp, jadamw.AdamWConfig(**cfg))
    ts = tadamw.init(tp, tadamw.AdamWConfig(**cfg))
    for step in range(3):
        g = _toy(30 + step, ml_dtypes.bfloat16)
        jp, js, _ = jadamw.apply(jp, js, _jtree(g), jadamw.AdamWConfig(**cfg))
        tadamw.apply(tp, ts, to_torch(g), tadamw.AdamWConfig(**cfg))
    for a, b in zip(tree_leaves(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), jp)), tree_leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(np_(b.float()), a, rtol=2 ** -7, atol=0)


def test_lr_schedule_equals_jax():
    for s in (0, 1, 5, 10, 11, 50, 99, 100):
        want = float(jadamw.lr_schedule(s, 1e-3, warmup=10, total=100))
        got = float(tadamw.lr_schedule(s, 1e-3, warmup=10, total=100))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(tadamw.lr_schedule(0, 1e-3)) == 0.0


# --- data pipeline -----------------------------------------------------------

@pytest.mark.parametrize("vocab", [64, 49152])
def test_synthetic_lm_batches_bit_equal_to_jax(vocab):
    jp = JSyntheticLM(JDataConfig(vocab, seq_len=24, global_batch=3, seed=7))
    tp = SyntheticLM(DataConfig(vocab, seq_len=24, global_batch=3, seed=7))
    for step in (0, 1, 13):
        a, b = jp.batch_np(step), tp.batch_np(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        t = tp.batch(step)
        assert t["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(t["labels"].numpy(), a["labels"])
        np.testing.assert_array_equal(
            np.asarray(jp.batch(step)["tokens"]), t["tokens"].numpy())


# --- checkpoints -------------------------------------------------------------

def _state_tree(quantized=True, seed=0):
    """A {params, opt} tree of both packages from one set of numpy values:
    bf16 params and, after one AdamW step, Q8 / bf16 (or f32) moments."""
    import ml_dtypes
    p = _toy(seed, ml_dtypes.bfloat16)
    cfg = dict(quantize_state=quantized)
    jp = _jtree(p)
    js = jadamw.init(jp, jadamw.AdamWConfig(**cfg))
    jp, js, _ = jadamw.apply(jp, js, _jtree(_toy(seed + 1, ml_dtypes.bfloat16)),
                             jadamw.AdamWConfig(**cfg))
    return {"params": jp, "opt": js}


def _assert_tree_equal(t, j):
    """The port's tree `t` holds the JAX tree `j`'s leaves bit for bit."""
    jl = jax.tree_util.tree_leaves_with_path(j)
    tflat = dict(tree_items(t))
    assert len(jl) == len(tflat)
    for path, leaf in jl:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        got = tflat[key]
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=key)
        else:
            assert got.shape == a.shape, key
            np.testing.assert_array_equal(np_(got), a, err_msg=key)


def test_tree_items_name_paths_as_the_reference():
    """`repro_torch.tree.tree_items` walks a tree of a QuantizedTensor, a
    Q8 moment and a tuple in the reference's leaf order and names every
    tensor as `jax.tree_util.tree_leaves_with_path` does, the paths the
    checkpoints of both packages are keyed by; bit for bit."""
    from repro.core import quant as jquant
    rng = np.random.default_rng(5)
    jtree = {"w": jquant.quantize(jnp.asarray(rng.normal(size=(16, 8)),
                                              jnp.float32), 8, axis=0),
             "m": jadamw._q8(jnp.asarray(rng.normal(size=(300,)),
                                         jnp.float32)),
             "s": (jnp.zeros(3), jnp.ones(2))}
    want = [("/".join(str(getattr(p, "name", getattr(p, "key",
                                                     getattr(p, "idx", p))))
                      for p in path), np.asarray(a))
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)]
    got = tree_items(to_torch(jax.tree_util.tree_map(np.asarray, jtree)))
    assert [k for k, _ in got] == [k for k, _ in want] == [
        "m/0", "m/1", "s/0", "s/1", "w/values", "w/scale"]
    for (_, t), (_, a) in zip(got, want):
        np.testing.assert_array_equal(np_(t), a)


@pytest.mark.parametrize("quantized", [False, True])
def test_checkpoint_roundtrip_bf16_and_q8(tmp_path, quantized):
    t = to_torch(jax.tree_util.tree_map(np.asarray,
                                        _state_tree(quantized)))
    tckpt.save(str(tmp_path), 7, t)
    assert tckpt.latest_step(str(tmp_path)) == 7
    back = tckpt.restore(str(tmp_path), 7, t)
    a, b = dict(tree_items(t)), dict(tree_items(back))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        man = json.load(f)["leaves"]
    assert man["params/a/w"] == {"dtype": "bfloat16", "shape": [3, 64, 40]}
    assert man["opt/step"] == {"dtype": "int32", "shape": []}
    if quantized:
        assert man["opt/m/a/w/0"]["dtype"] == "int8"
        assert man["opt/m/a/w/1"]["dtype"] == "float32"


def test_checkpoint_async_and_prune(tmp_path):
    tree = {"x": torch.arange(10), "y": (torch.ones(3), torch.zeros(2))}
    for s in (1, 2, 3, 4):
        tckpt.save(str(tmp_path), s, tree, blocking=False).join()
    tree["x"] += 1                      # the snapshot was taken at save
    tckpt.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    back = tckpt.restore(str(tmp_path), 4, tree)
    assert torch.equal(back["x"], torch.arange(10))
    assert torch.equal(back["y"][0], torch.ones(3))
    with pytest.raises(KeyError):
        tckpt.restore(str(tmp_path), 4, {"z": torch.zeros(1)})


@pytest.mark.parametrize("quantized", [False, True])
def test_checkpoint_cross_read_both_ways(tmp_path, quantized):
    """A granite smoke {params, opt} tree (bf16 params, Q8 moments): the JAX
    package's `ckpt.save` restores in the port bit for bit, and the port's
    `save` restores in the JAX package bit for bit."""
    import ml_dtypes
    jc, _ = smoke_pair("granite-8b")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    cfg = jadamw.AdamWConfig(quantize_state=quantized)
    js = jadamw.init(jp, cfg)
    g = jax.tree_util.tree_map(lambda x: (x * 0.5 + 0.01).astype(x.dtype), jp)
    jp, js, _ = jadamw.apply(jp, js, g, cfg)
    jtree = {"params": jp, "opt": js}
    assert ml_dtypes.bfloat16 == np.asarray(jp["embed"]["embedding"]).dtype

    jckpt.save(str(tmp_path / "jax"), 3, jtree)
    skeleton = to_torch(jax.tree_util.tree_map(np.zeros_like, jtree))
    back = tckpt.restore(str(tmp_path / "jax"), 3, skeleton)
    _assert_tree_equal(back, jtree)

    tckpt.save(str(tmp_path / "port"), 5, back)
    jback = jckpt.restore(str(tmp_path / "port"), 5, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(jback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
