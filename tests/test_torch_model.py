"""repro_torch.models vs repro.models on the granite-8b smoke config (2
layers, d=64, 4/2 heads, f32): layers, GQA, and prefill/decode logits in
the dense and paged KV layouts, fp and int8 KV, unquantized and 2/4/8-bit
BRAMAC weights.  Same numpy inputs on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bramac_linear as jbl
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.core import bramac_linear as tbl
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_convert import np_, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")

B, MAX_SEQ, PS = 2, 32, 16
TABLES = np.asarray([[2, 0], [3, 1]], np.int32)       # shuffled page ids
# f32 tolerances: unquantized logits differ by float reassociation only
# (matmul blocking, softmax sums); with quantized activations a last-bit
# difference ahead of a quantizer can move one value by one quantization
# step, which moves a logit by up to ~1e-2 at these widths
ATOL_FP, ATOL_Q = 1e-4, 5e-2


@pytest.fixture(scope="module")
def params():
    jc, _ = smoke_pair()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


def _rng_x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rmsnorm_and_rope_match():
    x = _rng_x(0, (2, 5, 4, 16))
    scale = _rng_x(1, (16,))
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    a = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    b = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=1e-6)  # f32 ulps
    for theta in (10_000.0, 10_000_000.0):
        a = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        b = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        # pow/sin/cos implementations may differ by an f32 ulp
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=1e-5)


def test_gqa_matches(params):
    jp, tp = params
    jc, tc = smoke_pair()
    x = _rng_x(2, (2, 7, 64))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["pos0"]["mixer"])
    pt = {k: v[0] for k, v in tp["layers"]["pos0"]["mixer"].items()}
    a, _ = JA.gqa(pj, jnp.asarray(x), jc, jnp.asarray(pos))
    b, _ = TA.gqa(pt, torch.from_numpy(x), tc, torch.from_numpy(pos))
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_FP)


def _serving(params, bits):
    jp, tp = params
    if not bits:
        return jp, tp
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    return jbl.tree_prepare_serving(jp, q), tbl.tree_prepare_serving(
        tp, tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits))


def _jax_run(cfg, p, toks, layout, steps):
    """prefill + `steps` greedy decode steps; returns stacked logits."""
    paged = layout == "paged"
    caches = JM.init_cache(cfg, B, MAX_SEQ, num_pages=4 if paged else None)
    pv = JA.PagedKV(tables=jnp.asarray(TABLES),
                    n_pages=jnp.full((B,), 2, jnp.int32),
                    write_mask=jnp.ones((B,), bool), max_seq=MAX_SEQ,
                    page_size=PS) if paged else None
    S = toks.shape[1]
    lg, _, caches = JM.forward(p, {"tokens": jnp.asarray(toks)}, cfg, caches,
                               jnp.zeros((B,), jnp.int32), last_only=True,
                               paged=pv)
    out = [np.asarray(lg[:, -1])]
    for i in range(steps):
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
        lg, caches = JM.decode_step(p, tok, cfg, caches,
                                    jnp.full((B,), S + i, jnp.int32), paged=pv)
        lg = lg[:, None]
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out), caches


def _torch_run(cfg, p, toks, layout, steps, decode_kernel=False):
    paged = layout == "paged"
    caches = TM.init_cache(cfg, B, MAX_SEQ, num_pages=4 if paged else None)
    pv = TA.PagedKV(tables=torch.from_numpy(TABLES),
                    n_pages=torch.full((B,), 2, dtype=torch.int32),
                    write_mask=torch.ones((B,), dtype=torch.bool),
                    max_seq=MAX_SEQ, page_size=PS,
                    decode_kernel=decode_kernel) if paged else None
    S = toks.shape[1]
    lg, _, caches = TM.forward(p, {"tokens": torch.from_numpy(toks)}, cfg,
                               caches, torch.zeros((B,), dtype=torch.int32),
                               last_only=True, paged=pv)
    out = [np_(lg[:, -1])]
    for i in range(steps):
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        lg, caches = TM.decode_step(p, tok, cfg, caches,
                                    torch.full((B,), S + i, dtype=torch.int32),
                                    paged=pv)
        lg = lg[:, None]
        out.append(np_(lg[:, -1]))
    return np.stack(out), caches


# every layout, KV kind and weight width appears at least once
CASES = [("dense", "fp", 0), ("paged", "fp", 8), ("paged", "int8", 0),
         ("dense", "int8", 8), ("paged", "fp", 2), ("dense", "fp", 4)]


@pytest.mark.parametrize("layout,kv,bits", CASES)
def test_prefill_decode_logits_match_jax(params, layout, kv, bits):
    """Prefill (11-token prompts) then 3 greedy decode steps: logits
    allclose to the reference's, with the tolerance stated above (int8 KV
    requantizes K, V and the probabilities, so it takes ATOL_Q too)."""
    jc, tc = smoke_pair(quant_kv=kv == "int8", quant_bits=bits)
    jp, tp = _serving(params, bits)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, 11)
                                             ).astype(np.int32)
    a, ja = _jax_run(jc, jp, toks, layout, 3)
    b, tb = _torch_run(tc, tp, toks, layout, 3)
    atol = ATOL_Q if bits or kv == "int8" else ATOL_FP
    np.testing.assert_allclose(b, a, atol=atol)
    # the caches agree too: fp rows to reassociation, int8 rows to within
    # one quantization step
    for key in tb["pos0"]:
        got, want = np_(tb["pos0"][key]), np.asarray(ja["pos0"][key])
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, key
        else:
            np.testing.assert_allclose(got, want, atol=atol, err_msg=key)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_port_paged_equals_dense(params, kv):
    """Inside the port the paged layout reproduces the dense layout bit for
    bit (masked pool rows contribute exact zeros), and the paged-decode
    kernel path (its plain version on the CPU) agrees with the gather to
    fp32 reassociation (atol 2e-6 on the attention, looser on logits)."""
    _, tc = smoke_pair(quant_kv=kv == "int8", quant_bits=8)
    _, tp = _serving(params, 8)
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, (B, 13)
                                             ).astype(np.int32)
    dense, _ = _torch_run(tc, tp, toks, "dense", 4)
    paged, _ = _torch_run(tc, tp, toks, "paged", 4)
    np.testing.assert_array_equal(dense, paged)
    kern, _ = _torch_run(tc, tp, toks, "paged", 4, decode_kernel=True)
    np.testing.assert_allclose(kern, paged, atol=ATOL_Q)


def test_negative_position_write_leaves_pool_untouched():
    """A negative position must not wrap into a live page (the reference's
    `positions >= 0` guard), nor may masked / out-of-range rows write."""
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(4, PS, 2, 8)).astype(np.float32)
    new = rng.normal(size=(B, 3, 2, 8)).astype(np.float32)
    positions = np.asarray([[-3, -1, 0], [5, 40, 17]], np.int32)
    wm = np.asarray([True, True])
    jpv = JA.PagedKV(tables=jnp.asarray(TABLES),
                     n_pages=jnp.asarray([2, 1], jnp.int32),
                     write_mask=jnp.asarray(wm), max_seq=MAX_SEQ, page_size=PS)
    want = JA.paged_update(jnp.asarray(pool), jnp.asarray(new),
                           jnp.asarray(positions), jpv)
    tpv = TA.PagedKV(tables=torch.from_numpy(TABLES),
                     n_pages=torch.tensor([2, 1], dtype=torch.int32),
                     write_mask=torch.from_numpy(wm), max_seq=MAX_SEQ,
                     page_size=PS)
    got = TA.paged_update(torch.from_numpy(pool.copy()), torch.from_numpy(new),
                          torch.from_numpy(positions), tpv)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    # only (slot 0, pos 0) and (slot 1, pos 5) were written
    changed = np.argwhere((np_(got) != pool).any(axis=(2, 3)))
    assert changed.tolist() == [[2, 0], [3, 5]]
    # nothing kept at all: the pool comes back unchanged
    tpv.write_mask = torch.zeros(2, dtype=torch.bool)
    same = TA.paged_update(torch.from_numpy(pool.copy()),
                           torch.from_numpy(new), torch.from_numpy(positions),
                           tpv)
    np.testing.assert_array_equal(np_(same), pool)
