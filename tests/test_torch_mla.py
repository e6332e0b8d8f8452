"""The MLA mixer in the port (`models.attention.mla`, `init_mla`,
`init_mla_cache`; the `mla+dense` blocks of `models.transformer`) against
the JAX package's on the minicpm3-4b smoke config (2 layers, d=64, 4 heads,
q_lora 32, kv_lora 16, f32), on the same numpy inputs.

The block output and the cache it writes agree with the reference's with
no cache, a dense cache (contiguous and scattered writes) and the paged
layout, to f32 reassociation (atol 1e-5).  The 8-bit serving tree crosses
leaf for leaf; prefill and decode logits agree (fp atol 1e-4, quantized
5e-2: one activation rounding the other way moves a logit by one step).
At the Engine level, greedy streams equal the JAX Engine's — paged, dense,
prefix cache on, speculation with both drafters — and the paged-decode
kernels, which read GQA pools only, are never MLA's path even when the
engine asks for them."""
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
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.runtime.serve import Engine as TEngine
from repro_torch.tree import tree_map
from test_torch_convert import leaves, np_, smoke_pair, to_torch
from test_torch_model import ATOL_FP, ATOL_Q, B, _jax_run, _torch_run

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

ARCH = "minicpm3-4b"
# f32 agreement of one block: the same arithmetic up to reassociation
ATOL_BLOCK = 1e-5


@pytest.fixture(scope="module")
def params():
    jc, _ = smoke_pair(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


_SERVING = {}


def _serving(params, bits):
    """Both sides' `bits`-bit serving trees of the `params` fixture's
    trees (bits_a = bits), quantized once for the module's tests."""
    if bits not in _SERVING:
        jp, tp = params
        q = dict(enabled=True, bits_w=bits, bits_a=bits)
        _SERVING[bits] = (jbl.tree_prepare_serving(jp, jbl.QuantConfig(**q)),
                          tbl.tree_prepare_serving(tp, tbl.QuantConfig(**q)))
    return _SERVING[bits]


def _block_inputs(seed, cfg, S, offsets):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = (np.asarray(offsets, np.int32)[:, None]
           + np.arange(S, dtype=np.int32)[None])
    return rng, x, pos


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_close(t, j, atol):
    for key in t:
        np.testing.assert_allclose(np_(t[key]), np.asarray(j[key]),
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", ["none", "dense", "dense_kv", "paged"])
def test_mla_block_matches_jax(params, mode):
    """One mla mixer call: a 4-token chunk at offsets (5, 2) against
    caches already holding random earlier rows (no cache: a 7-token causal
    pass).  Output and written cache within ATOL_BLOCK."""
    jp, tp = params
    jc, tc = smoke_pair(ARCH)
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["pos0"]["mixer"])
    pt = tree_map(lambda a: a[0], tp["layers"]["pos0"]["mixer"])
    if mode == "none":
        _, x, pos = _block_inputs(1, tc, 7, (0, 0))
        a, ca = JA.mla(pj, jnp.asarray(x), jc, jnp.asarray(pos))
        b, cb = TA.mla(pt, torch.from_numpy(x), tc, torch.from_numpy(pos))
        assert ca is None and cb is None
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_BLOCK)
        return
    offsets = (5, 2)
    rng, x, pos = _block_inputs(2, tc, 4, offsets)
    S_max, ps = 32, tc.page_size
    if mode == "paged":
        lead = (4, ps)
        tables = np.asarray([[3, 1], [0, 2]], np.int32)
        jkw = dict(paged=JA.PagedKV(
            tables=jnp.asarray(tables), n_pages=jnp.asarray([2, 1]),
            write_mask=jnp.asarray([True, True]), max_seq=S_max,
            page_size=ps))
        tkw = dict(paged=TA.PagedKV(
            tables=torch.from_numpy(tables),
            n_pages=torch.tensor([2, 1], dtype=torch.int32),
            write_mask=torch.tensor([True, True]), max_seq=S_max,
            page_size=ps, decode_kernel=True))
    else:
        lead = (B, S_max)
        if mode == "dense_kv":
            jkw = dict(paged=JA.DenseKV(write_mask=jnp.asarray([True, False]),
                                        max_seq=S_max))
            tkw = dict(paged=TA.DenseKV(write_mask=torch.tensor([True, False]),
                                        max_seq=S_max))
        else:
            jkw = dict(cache_pos=jnp.asarray(offsets, jnp.int32))
            tkw = dict(cache_pos=torch.tensor(offsets, dtype=torch.int32))
    cache = {"c_kv": rng.normal(size=lead + (tc.kv_lora_rank,))
             .astype(np.float32),
             "k_rope": rng.normal(size=lead + (tc.qk_rope_dim,))
             .astype(np.float32)}
    a, ca = JA.mla(pj, jnp.asarray(x), jc, jnp.asarray(pos), _j(cache), **jkw)
    tcache = to_torch(cache)
    b, cb = TA.mla(pt, torch.from_numpy(x), tc, torch.from_numpy(pos), tcache,
                   **tkw)
    assert cb is tcache                         # written in place
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_BLOCK)
    _assert_tree_close(cb, ca, ATOL_BLOCK)


def test_mla_cache_and_pool_flags(params):
    """The latent cache is c_kv and k_rope in the compute dtype whatever
    quant_kv says, both pool leaves; the port's own init builds the
    reference's tree."""
    _, tc = smoke_pair(ARCH, quant_kv=True)
    c = TM.init_cache(tc, 3, 32, num_pages=5)
    assert sorted(c["pos0"]) == ["c_kv", "k_rope"]
    assert tuple(c["pos0"]["c_kv"].shape) == (2, 5, 16, 16)
    assert tuple(c["pos0"]["k_rope"].shape) == (2, 5, 16, 8)
    assert c["pos0"]["c_kv"].dtype == torch.float32
    assert TM.cache_pool_flags(tc) == {"pos0": {"c_kv": True,
                                                "k_rope": True}}
    jp, tp = params
    own = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in leaves(own)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in leaves(tp)]


def test_smoke_serving_tree_carried_leaf_for_leaf(params):
    """tree_prepare_serving at 8 bits on both sides: the converted JAX
    tree equals the port's quantization of the converted float tree, int8
    values and f32 scales bit for bit — all seven MLA projections, the
    MLP's three and the unembedding."""
    jq, tq = _serving(params, 8)
    jq = to_torch(jq)
    jl, tl = leaves(jq), leaves(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    n_q = 0
    for (path, a), (_, b) in zip(jl, tl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            n_q += 1
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    assert n_q == 11


CASES = [("dense", 0), ("paged", 0), ("paged", 8), ("dense", 8),
         ("paged", 4)]


@pytest.mark.parametrize("layout,bits", CASES)
def test_prefill_decode_logits_match_jax(params, layout, bits):
    """Prefill (11-token prompts) then 3 greedy decode steps through the
    whole minicpm3 smoke model: logits within ATOL_FP (float) or ATOL_Q
    (quantized); the latent caches within the same."""
    jc, tc = smoke_pair(ARCH, quant_bits=bits)
    jp, tp = _serving(params, bits) if bits else params
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, 11)
                                             ).astype(np.int32)
    a, ja = _jax_run(jc, jp, toks, layout, 3)
    b, tb = _torch_run(tc, tp, toks, layout, 3)
    atol = ATOL_Q if bits else ATOL_FP
    np.testing.assert_allclose(b, a, atol=atol)
    _assert_tree_close(tb["pos0"], ja["pos0"], atol)
    # in the port, the paged layout reproduces the dense one bit for bit
    if layout == "paged":
        dense, _ = _torch_run(tc, tp, toks, "dense", 3)
        np.testing.assert_array_equal(dense, b)


def _jobs(vocab):
    """Prompts behind a shared 20-token stem (the prefix cache's hits end
    mid-page: copy-on-write), with repeats the n-gram drafter can find."""
    rng = np.random.default_rng(7)
    stem = list(rng.integers(1, vocab, 20))
    return [(stem + list(rng.integers(1, vocab, 4)) * 3, 12),
            (stem + list(rng.integers(1, vocab, 3)) * 2, 10),
            (list(rng.integers(1, vocab, 9)), 14),
            (stem + list(rng.integers(1, vocab, 6)), 9)]


def _serve(engine_cls, cfg, params, jobs, **kw):
    """Each job served to completion before the next arrives, so slot
    reuse and warm prefix admissions happen."""
    extra = {"device": "cpu"} if engine_cls is TEngine else {}
    eng = engine_cls(cfg, params, num_slots=2, max_seq=64, **kw, **extra)
    outs = []
    for prompt, n in jobs:
        r = eng.submit(prompt, n)
        eng.run()
        assert r.done
        outs.append(list(r.out_tokens))
    return outs, eng


def test_engine_greedy_streams_equal_jax(params, monkeypatch):
    """Greedy minicpm3 streams of the port's Engine equal the JAX
    Engine's: paged, dense, the prefix cache on (hits and copy-on-write,
    invariants checked), speculation with the n-gram and the 2-bit model
    drafter, and disaggregated.  A decode-kernel engine serves the same
    streams and never calls a decode kernel (they would raise here)."""
    jp, tp = params
    jc, tc = smoke_pair(ARCH)
    jobs = _jobs(tc.vocab_size)
    want, jeng = _serve(JEngine, jc, jp, jobs, prefix_cache=True,
                        check_invariants=True)
    runs = {"paged": dict(prefix_cache=False, check_invariants=True),
            "dense": dict(kv_layout="dense"),
            "prefix": dict(prefix_cache=True, check_invariants=True,
                           prefix_chunk=8),
            "ngram": dict(draft_len=4, drafter="ngram",
                          check_invariants=True),
            "model": dict(draft_len=4, drafter="model"),
            "disagg": dict(disagg=True, check_invariants=True)}
    for name, kw in runs.items():
        outs, eng = _serve(TEngine, tc, tp, jobs, **kw)
        assert outs == want, name
        if name == "prefix":
            st = eng.prefix_stats()
            assert st["hits"] >= 2 and eng.pages_shared_high_water >= 1
        if name in ("ngram", "model"):
            assert eng.spec_stats()["drafted"] > 0
        if name == "ngram":
            assert eng.spec_stats() == _serve(
                JEngine, jc, jp, jobs, **kw)[1].spec_stats()
    assert jeng.prefix_stats()["hits"] >= 1

    def refuse(*a, **k):
        raise AssertionError("a GQA decode kernel was called from mla")

    monkeypatch.setattr(TA.pk, "paged_decode", refuse)
    monkeypatch.setattr(TA.pk, "paged_decode_q", refuse)
    outs, eng = _serve(TEngine, tc, tp, jobs, decode_kernel=True,
                       prefix_cache=False)
    assert eng.decode_kernel and outs == want
