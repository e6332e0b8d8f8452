"""Cross-attention and the stub frontends in the port against the JAX
package on the same numpy inputs: the xattn block (`attention.xattn`,
K/V projected once from the vision embeddings and read from the per-slot
cache at decode), llama-3.2-vision-11b's smoke logits, prefill and decode
with `vision_embeds`, and musicgen-large's logits from `frame_embeds`.

Tolerances are test_torch_model's: ATOL_FP for f32 weights (fp32
reassociation), ATOL_Q for 8-bit serving weights (the activation
quantizer can round a near-half row the other way).  The port's Engine
refuses an xattn arch at construction (it feeds no vision inputs); the
reference's Engine fails at its first admission."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bramac_linear as jbl
from repro.models import attention as JA
from repro.models import model as JM
from repro.runtime.serve import Engine as JEngine
from repro_torch.core import bramac_linear as tbl
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import embed
from repro_torch.tree import tree_map
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import leaves, np_, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")

ATOL_FP, ATOL_Q = 1e-4, 5e-2
VLM = "llama-3.2-vision-11b"
B, S = 2, 7


@pytest.fixture(scope="module")
def vlm():
    jc, tc = smoke_pair(VLM)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, to_torch(jp)


def _tree(vlm, bits):
    """(JAX, port) params at f32, or both quantized for serving at `bits`
    on the JAX side and carried across."""
    jc, tc, jp, tp = vlm
    if not bits:
        return jp, tp
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    jq = jbl.tree_prepare_serving(jp, q)
    return jq, to_torch(jq)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ve = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, ve


def _pair(vlm, bits):
    jc, tc = smoke_pair(VLM, **({"quant_bits": bits} if bits else {}))
    return jc, tc, ATOL_Q if bits else ATOL_FP


@pytest.mark.parametrize("bits", [0, 8])
def test_xattn_block_equals_jax(vlm, bits):
    """One xattn mixer (period 0's): without a cache, then writing the
    cache at a 7-token prefill and reading it at a decode step, whose
    vision input is not looked at."""
    jc, tc, atol = _pair(vlm, bits)
    jp, tp = _tree(vlm, bits)
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["pos0"]["mixer"])
    pt = tree_map(lambda a: a[0], tp["layers"]["pos0"]["mixer"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    _, ve = _inputs(jc)
    a, _ = JA.xattn(pj, jnp.asarray(x), jc, jnp.asarray(ve))
    b, _ = TA.xattn(pt, torch.from_numpy(x), tc, torch.from_numpy(ve))
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)
    jcache = JA.init_xattn_cache(jc, B, jnp.float32)
    tcache = TA.init_xattn_cache(tc, B, torch.float32)
    a, jcache = JA.xattn(pj, jnp.asarray(x), jc, jnp.asarray(ve), jcache)
    b, tcache = TA.xattn(pt, torch.from_numpy(x), tc, torch.from_numpy(ve),
                         tcache)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)
    for k in ("k", "v"):
        np.testing.assert_allclose(np_(tcache[k]), np.asarray(jcache[k]),
                                   atol=atol)
    x1 = x[:, :1]
    a, _ = JA.xattn(pj, jnp.asarray(x1), jc, None, jcache)
    b, _ = TA.xattn(pt, torch.from_numpy(x1), tc, None, tcache)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)


@pytest.mark.parametrize("bits", [0, 8])
def test_vision_logits_equal_jax(vlm, bits):
    """The smoke stack's logits with vision embeddings (5 layers, one xattn
    period)."""
    jc, tc, atol = _pair(vlm, bits)
    jp, tp = _tree(vlm, bits)
    toks, ve = _inputs(jc)
    a, _, _ = JM.forward(jp, {"tokens": jnp.asarray(toks),
                              "vision_embeds": jnp.asarray(ve)}, jc)
    b, _, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks),
                              "vision_embeds": torch.from_numpy(ve)}, tc)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)


@pytest.mark.parametrize("bits", [0, 8])
def test_vision_prefill_decode_equal_jax(vlm, bits):
    """`prefill` with vision embeddings, then 3 greedy `decode_step`s
    (tokens only) on dense caches: logits and every cache leaf against the
    reference's; the xattn K/V stay as the prefill wrote them."""
    jc, tc, atol = _pair(vlm, bits)
    jp, tp = _tree(vlm, bits)
    toks, ve = _inputs(jc, 2)
    jcache = JM.init_cache(jc, B, S + 4)
    tcache = TM.init_cache(tc, B, S + 4)
    a, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks),
                                "vision_embeds": jnp.asarray(ve)}, jc, jcache)
    b, tcache = TM.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "vision_embeds": torch.from_numpy(ve)}, tc,
                           tcache)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)
    xkv = {k: tcache["pos0"][k].clone() for k in ("k", "v")}
    pos = np.full((B,), S, np.int32)
    for _ in range(3):
        nt = np.asarray(jnp.argmax(a, -1)).astype(np.int32)[:, None]
        a, jcache = JM.decode_step(jp, jnp.asarray(nt), jc, jcache,
                                   jnp.asarray(pos))
        b, tcache = TM.decode_step(tp, torch.from_numpy(nt), tc, tcache,
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=atol)
        pos += 1
    jl = leaves(jax.tree_util.tree_map(np.asarray, jcache))
    tl = leaves(tcache)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, want), (_, got) in zip(jl, tl):
        np.testing.assert_allclose(np_(got), want, atol=atol, err_msg=path)
    assert all(torch.equal(tcache["pos0"][k], xkv[k]) for k in xkv)


def test_vision_flags_and_serving_init(vlm):
    """The xattn cache leaves are per-slot (pool flag False, as the
    reference's); `init_params(serving=)` equals quantizing the float tree
    for the xattn arch too."""
    jc, tc, _, _ = vlm
    jflags = JM.cache_pool_flags(jc)
    tflags = TM.cache_pool_flags(tc)
    assert leaves(jax.tree_util.tree_map(bool, jflags)) == leaves(tflags)
    assert tflags["pos0"] == {"k": False, "v": False}
    q = tbl.QuantConfig(enabled=True, bits_w=8, bits_a=8)
    a = TM.init_params(tc, torch.Generator().manual_seed(3), "cpu",
                       serving=q)
    b = tbl.tree_prepare_serving(
        TM.init_params(tc, torch.Generator().manual_seed(3), "cpu"), q)
    for (pa, x), (pb, y) in zip(leaves(a), leaves(b)):
        assert pa == pb
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), pa
        else:
            assert torch.equal(x.values, y.values) and \
                torch.equal(x.scale, y.scale), pa


def test_musicgen_frame_embeds_equal_jax():
    """musicgen-large's audio stub frontend: logits from frame embeddings
    against the reference's, `prefill` of a frame batch (no tokens) and
    one decode step; and in the port a forward from `embed(tokens)` equals
    the token forward bit for bit."""
    jc, tc = smoke_pair("musicgen-large")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = to_torch(jp)
    rng = np.random.default_rng(4)
    fe = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    a, _, _ = JM.forward(jp, {"frame_embeds": jnp.asarray(fe)}, jc)
    b, _, _ = TM.forward(tp, {"frame_embeds": torch.from_numpy(fe)}, tc)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_FP)
    jcache = JM.init_cache(jc, B, S + 2)
    tcache = TM.init_cache(tc, B, S + 2)
    a, jcache = JM.prefill(jp, {"frame_embeds": jnp.asarray(fe)}, jc, jcache)
    b, tcache = TM.prefill(tp, {"frame_embeds": torch.from_numpy(fe)}, tc,
                           tcache)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_FP)
    nt = np.asarray(jnp.argmax(a, -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    a, _ = JM.decode_step(jp, jnp.asarray(nt), jc, jcache, jnp.asarray(pos))
    b, _ = TM.decode_step(tp, torch.from_numpy(nt), tc, tcache,
                          torch.from_numpy(pos))
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_FP)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (B, S)).astype(
        np.int32))
    by_tok, _, _ = TM.forward(tp, {"tokens": toks}, tc)
    by_frame, _, _ = TM.forward(
        tp, {"frame_embeds": embed(tp["embed"], toks)}, tc)
    assert torch.equal(by_tok, by_frame)


def test_engine_refuses_xattn_arch(vlm):
    """The port's Engine refuses llama-3.2-vision at construction, saying it
    feeds no vision inputs; the reference's Engine is built but fails at
    the first admission (it normalises a missing vision_embeds)."""
    jc, tc, jp, tp = vlm
    with pytest.raises(NotImplementedError, match="vision"):
        TEngine(tc, tp, num_slots=2, max_seq=32, device="cpu")
    eng = JEngine(jc, jp, num_slots=2, max_seq=32)
    eng.submit([1, 2, 3, 4, 5], 3)
    with pytest.raises(AttributeError):
        eng.run()
