"""QAT and the training loss in the port against the JAX package on the
same numpy inputs: `ops.bramac_dense` (the fake-quant dense with
straight-through gradients), `layers.cross_entropy` and `model.loss_fn`,
differentiated by autograd against `jax.value_and_grad`.

Tolerances: the fake-quant forward runs the same integer digit passes on
both sides, so it is bit-exact wherever the float inputs to the
quantizers are; its STE gradients are plain f32 products (rtol 1e-5).
The loss and gradients of one smoke step agree within RTOL_GRAD of each
leaf's largest gradient (f32 reassociation through a few layers; xlstm's
exponential gating grows it to ~1e-3, as in test_torch_recurrent)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

RTOL_GRAD = 2e-3
ATOL_LOSS = 1e-5


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bramac_dense_forward_and_ste_grads_equal_jax(bits):
    """tests/test_kernels.py's STE shapes (4x32 @ 32x16) and a 3-D input:
    the forward bit for bit, dx = g @ w^T and dw = x^T @ g as JAX's VJP."""
    rng = np.random.default_rng(5)
    for xshape in ((4, 32), (2, 3, 32)):
        x = rng.normal(size=xshape).astype(np.float32)
        w = rng.normal(size=(32, 16)).astype(np.float32)
        g = rng.normal(size=xshape[:-1] + (16,)).astype(np.float32)
        jy, vjp = jax.vjp(lambda a, b: jops.bramac_dense(a, b, bits, bits),
                          jnp.asarray(x), jnp.asarray(w))
        jgx, jgw = vjp(jnp.asarray(g))
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        ty = tops.bramac_dense(tx, tw, bits, bits)
        ty.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                                   rtol=1e-5, atol=1e-5)


def test_bramac_dense_bf16_casts_as_the_reference():
    """bf16 operands: the forward's output dtype and the STE grads' dtypes
    follow the inputs, as `_bramac_dense_bwd` casts them."""
    x = torch.randn(6, 32, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(32, 8, dtype=torch.bfloat16, requires_grad=True)
    y = tops.bramac_dense(x, w, 8, 8)
    y.sum().backward()
    assert y.dtype == x.grad.dtype == w.grad.dtype == torch.bfloat16


def test_cross_entropy_equals_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _batch(cfg, B=2, S=8, seed=0):
    """A training batch of the arch's kind: tokens, plus vision embeddings
    (vlm), or frame embeddings in place of tokens (audio)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.audio_frontend:
        batch["frame_embeds"] = rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    return batch


def _grad_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _grad_leaves(tree[k],
                                                             path + (k,))]
    return [(".".join(path), tree)]


# the hybrid and 16-expert archs, whose JAX compiles take ~10-18 s each,
# are in test_torch_train_hybrid.py
HYBRID = ("jamba-1.5-large-398b", "xlstm-1.3b", "dbrx-132b")
CASES = [(a, 0) for a in jconfigs.ARCH_IDS if a not in HYBRID] + [
    ("granite-8b", 8), ("qwen3-moe-30b-a3b", 8)]


def check_loss_and_grads(arch, bits):
    """One smoke step of `arch`: loss, its ce/aux parts and the gradient of
    every parameter leaf against `jax.value_and_grad(M.loss_fn)`; `bits`
    > 0 trains with QAT at bits/bits (the aux loss of an MoE arch enters
    the total with weight 0.01)."""
    jc, tc = smoke_pair(arch, **({"quant_bits": bits} if bits else {}))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    batch = _batch(jc)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jc), has_aux=True)(jp)
    tp = to_torch(jp)
    for _, leaf in _grad_leaves(tp):
        leaf.requires_grad_(True)
    tl, tparts = TM.loss_fn(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tc)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= ATOL_LOSS * max(1, abs(float(jl)))
    for k in ("ce", "aux"):
        assert abs(tparts[k].item() - float(jparts[k])) <= ATOL_LOSS * max(
            1, abs(float(jparts[k]))), k
    if any("moe" in spec for spec in jc.layer_pattern):
        assert tparts["aux"].item() > 0
    jleaves = _grad_leaves(jax.tree_util.tree_map(np.asarray, jg))
    tleaves = _grad_leaves(tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    nonzero = 0
    for (path, want), (_, t) in zip(jleaves, tleaves):
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL_GRAD * scale, err_msg=path)
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > len(jleaves) // 2


@pytest.mark.parametrize("arch,bits", CASES,
                         ids=[f"{a}-{'q8' if b else 'fp'}" for a, b in CASES])
def test_loss_and_grads_equal_jax(arch, bits):
    """Float weights for every attention arch, and QAT 8/8 bits for
    granite-8b and qwen3-moe (which also covers the aux loss)."""
    check_loss_and_grads(arch, bits)
