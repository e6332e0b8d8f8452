"""The recurrent mixers in the port (`models.xlstm`: mLSTM and sLSTM,
`models.mamba`, the `mamba` / `mlstm` / `slstm` blocks and the `none` FF of
`models.transformer`) and the Engine's recurrent handling, against the JAX
package's, on the xlstm-1.3b and jamba-1.5-large-398b smoke configs (8
layers, d=64, f32) and the same numpy inputs.

Tolerances: the f32 blocks agree with JAX's within the reference's own
rtol = atol = 2e-4 (tests/test_model_invariants.py), the port's own
chunkwise == recurrent and chunked == stepwise invariants within the same;
8-bit serving blocks within test_torch_model's ATOL_Q; f32 logits and
caches of the 8-layer stacks within RTOL_STACK, relative and of the max
(xlstm's exponential gating and its residual stream without an FF grow
a block's ~1e-6 to ~1e-4 on logits up to ~4, and more on the
accumulated mLSTM state).  Greedy Engine streams equal the JAX
Engine's: paged and dense, prefill one token at a time, the prefix cache
and speculation opting out silently, and a reused slot starting from the
init state."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bramac_linear as jbl
from repro.models import mamba as JMb
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.runtime.serve import Engine as JEngine
from repro_torch.core import bramac_linear as tbl
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as tlaunch
from repro_torch.models import mamba as TMb
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.runtime import pages as pg
from repro_torch.runtime.serve import Engine as TEngine
from repro_torch.tree import tree_leaves, tree_map
from test_torch_convert import leaves, np_, smoke_pair, to_torch
from test_torch_model import ATOL_Q

jax.config.update("jax_platform_name", "cpu")

XL, JB = "xlstm-1.3b", "jamba-1.5-large-398b"
TOL = dict(rtol=2e-4, atol=2e-4)
RTOL_STACK = 1e-3


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX float tree, the same tree in the port) of an arch's smoke
    config."""
    jc, _ = smoke_pair(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


@pytest.fixture(scope="module", params=[XL, JB])
def arch_params(request):
    """(arch, JAX float tree, the same tree in the port)."""
    return (request.param,) + _params(request.param)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jmixer(tree, pos):
    """The first period's mixer parameters of pattern position `pos`."""
    return jax.tree_util.tree_map(lambda a: a[0],
                                  tree["layers"][f"pos{pos}"]["mixer"])


def _close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)


# --- trees ------------------------------------------------------------------

def test_tree_map_and_walkers_take_tuples():
    """A tuple state is mapped leaf by leaf (a dict-only walk would hand it
    back unmapped), with flag trees alongside; tree_leaves keeps tuple
    order; the pool walkers leave per-slot leaves alone."""
    tree = {"b": (torch.ones(2), torch.zeros(3)), "a": {"c": torch.ones(1)}}
    flags = {"b": (False, True), "a": {"c": True}}
    out = tree_map(lambda t, f: t + (10 if f else 20), tree, flags)
    assert isinstance(out["b"], tuple)
    assert out["b"][0].tolist() == [21.0, 21.0]
    assert out["b"][1].tolist() == [10.0] * 3 and out["a"]["c"].item() == 11
    assert [t.numel() for t in tree_leaves(tree)] == [1, 2, 3]
    _, tc = smoke_pair(JB)
    caches = TM.init_cache(tc, 2, 32, num_pages=4)
    flags = TM.cache_pool_flags(tc)
    assert isinstance(caches["pos0"], tuple) and flags["pos0"] == (False,
                                                                   False)
    assert all(tree_leaves(flags["pos4"]))
    h = caches["pos0"][0]
    h.fill_(3.0)
    pg.cow_copy(caches, flags, torch.tensor([1, -1]), torch.tensor([2, 3]))
    tiles = pg.export_pages(caches, flags, torch.tensor([0, 1]))
    assert tiles["pos0"][0].shape[1] == 0 and tiles["pos4"]["k"].shape[1] == 2
    assert bool((h == 3.0).all())


def test_cache_trees_carried_across(arch_params):
    """The reference's init caches (paged and dense) cross with their
    tuples: same structure, shapes, dtypes and values (m starts at -1e30)
    as the port's own."""
    arch, _, _ = arch_params
    jc, tc = smoke_pair(arch)
    for pages in (4, None):
        got = to_torch(JM.init_cache(jc, 2, 32, num_pages=pages))
        own = TM.init_cache(tc, 2, 32, num_pages=pages)
        assert jax.tree_util.tree_structure(
            tree_map(lambda t: 0, got)) == jax.tree_util.tree_structure(
            tree_map(lambda t: 0, own))
        for a, b in zip(tree_leaves(got), tree_leaves(own)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree_map(lambda t, f: f, own, TM.cache_pool_flags(tc)) == \
        TM.cache_pool_flags(tc)


# --- mLSTM --------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_mlstm_chunkwise_matches_jax(chunk):
    """mlstm_sequence (chunks of 2/4/8 over 16 steps), its final (C, n, m),
    mlstm_step from a mid-sequence state, and mlstm_recurrent_ref, each
    within TOL of JAX's."""
    jc, tc = smoke_pair(XL, chunk_size=chunk)
    pj = JX.init_mlstm(jax.random.PRNGKey(chunk), jc)
    pt = to_torch(pj)
    x = _x(chunk, (2, 16, jc.d_model))
    a, sa = JX.mlstm_sequence(pj, jnp.asarray(x), jc)
    b, sb = TX.mlstm_sequence(pt, torch.from_numpy(x), tc)
    _close((b, sb), (a, sa))
    a, sa = JX.mlstm_step(pj, jnp.asarray(x[:, :1]), jc, sa)
    b, sb = TX.mlstm_step(pt, torch.from_numpy(x[:, :1]), tc, sb)
    _close((b, sb), (a, sa))
    _close(TX.mlstm_recurrent_ref(pt, torch.from_numpy(x[:, :6]), tc),
           JX.mlstm_recurrent_ref(pj, jnp.asarray(x[:, :6]), jc))


@pytest.mark.parametrize("seed,chunk,S", [(0, 2, 8), (1, 4, 16), (2, 8, 16)])
def test_mlstm_chunkwise_equals_recurrent(seed, chunk, S):
    """The port's own invariant (tests/test_model_invariants.py:32): the
    chunkwise form equals the step-by-step oracle."""
    _, tc = smoke_pair(XL, chunk_size=chunk)
    p = TX.init_mlstm(torch.Generator().manual_seed(seed), tc, "cpu")
    x = torch.randn((2, S, tc.d_model),
                    generator=torch.Generator().manual_seed(seed + 100))
    seq, _ = TX.mlstm_sequence(p, x, tc)
    np.testing.assert_allclose(np_(seq), np_(TX.mlstm_recurrent_ref(p, x, tc)),
                               **TOL)


# --- sLSTM --------------------------------------------------------------------

def test_slstm_matches_jax_and_steps():
    """slstm_sequence and its (h, c, n, m), then a step, within TOL of
    JAX's; the sequence equals its own steps (test_model_invariants.py:70)."""
    jc, tc = smoke_pair(XL)
    pj = JX.init_slstm(jax.random.PRNGKey(7), jc)
    pt = to_torch(pj)
    x = _x(7, (2, 8, jc.d_model))
    a, sa = JX.slstm_sequence(pj, jnp.asarray(x), jc)
    b, sb = TX.slstm_sequence(pt, torch.from_numpy(x), tc)
    _close((b, sb), (a, sa))
    a, sa = JX.slstm_step(pj, jnp.asarray(x[:, :1]), jc, sa)
    b, sb = TX.slstm_step(pt, torch.from_numpy(x[:, :1]), tc, sb)
    _close((b, sb), (a, sa))
    state, outs = TX.init_slstm_state(tc, 2), []
    for t in range(8):
        o, state = TX.slstm_step(pt, torch.from_numpy(x[:, t:t + 1]), tc,
                                 state)
        outs.append(o)
    seq, _ = TX.slstm_sequence(pt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(np_(seq), np_(torch.cat(outs, 1)), **TOL)


# --- mamba --------------------------------------------------------------------

def test_softplus_is_logaddexp():
    x = np.asarray([-50.0, -3.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(
        np_(TMb.softplus(torch.from_numpy(x))),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba_matches_jax(chunk):
    """mamba_sequence (16 steps in chunks of 4, and one chunk) with its
    (h, conv_tail), then a step from that state, within TOL of JAX's."""
    jc, tc = smoke_pair(JB, chunk_size=chunk)
    pj = JMb.init_mamba(jax.random.PRNGKey(chunk), jc)
    pt = to_torch(pj)
    x = _x(chunk, (2, 16, jc.d_model))
    a, sa = JMb.mamba_sequence(pj, jnp.asarray(x), jc)
    b, sb = TMb.mamba_sequence(pt, torch.from_numpy(x), tc)
    assert isinstance(sb, tuple) and len(sb) == 2
    _close((b, sb), (a, sa))
    a, sa = JMb.mamba_step(pj, jnp.asarray(x[:, :1]), jc, sa)
    b, sb = TMb.mamba_step(pt, torch.from_numpy(x[:, :1]), tc, sb)
    _close((b, sb), (a, sa))


@pytest.mark.parametrize("seed,chunk", [(0, 2), (1, 4), (2, 16)])
def test_mamba_chunked_equals_stepwise(seed, chunk):
    """The port's own invariant (tests/test_model_invariants.py:46)."""
    _, tc = smoke_pair(JB, chunk_size=chunk)
    p = TMb.init_mamba(torch.Generator().manual_seed(seed), tc, "cpu")
    x = torch.randn((2, 16, tc.d_model),
                    generator=torch.Generator().manual_seed(seed + 100))
    seq, (hT, tail) = TMb.mamba_sequence(p, x, tc)
    state, outs = TMb.init_mamba_state(tc, 2, x.dtype), []
    for t in range(16):
        o, state = TMb.mamba_step(p, x[:, t:t + 1], tc, state)
        outs.append(o)
    np.testing.assert_allclose(np_(seq), np_(torch.cat(outs, 1)), **TOL)
    np.testing.assert_allclose(np_(hT), np_(state[0]), **TOL)
    assert torch.equal(tail, state[1])


# --- 8-bit serving blocks -----------------------------------------------------

@pytest.mark.parametrize("arch,pos,fn", [
    (XL, 0, "mlstm_sequence"), (XL, 7, "slstm_sequence"),
    (JB, 0, "mamba_sequence")])
def test_quantized_blocks_match_jax(arch, pos, fn):
    """Each mixer on 8-bit serving weights (its servable linears through
    the BRAMAC matmul's plain version): within ATOL_Q of JAX's."""
    jp, _ = _params(arch)
    jc, tc = smoke_pair(arch, quant_bits=8)
    pj = jbl.tree_prepare_serving(_jmixer(jp, pos), jc.quant)
    pt = to_torch(pj)
    assert any(isinstance(v, QuantizedTensor) for v in pt.values())
    x = _x(pos, (2, 8, jc.d_model))
    mod_j, mod_t = (JX, TX) if arch == XL else (JMb, TMb)
    a, _ = getattr(mod_j, fn)(pj, jnp.asarray(x), jc)
    b, _ = getattr(mod_t, fn)(pt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_Q)


# --- the stack ------------------------------------------------------------------

B, MAX_SEQ = 2, 32


def _decode_run(M, cfg, p, toks, steps, layout, mk):
    """prefill (whole prompt) then `steps` greedy decode steps; `mk` wraps
    arrays for M's side.  Returns stacked last-position logits."""
    pages = 4 if layout == "paged" else None
    caches = M.init_cache(cfg, B, MAX_SEQ, num_pages=pages)
    if M is JM:
        from repro.models import attention as A
        pv = A.PagedKV(tables=jnp.asarray([[2, 0], [3, 1]], jnp.int32),
                       n_pages=jnp.full((B,), 2, jnp.int32),
                       write_mask=jnp.ones((B,), bool), max_seq=MAX_SEQ,
                       page_size=16) if pages else None
    else:
        from repro_torch.models import attention as A
        pv = A.PagedKV(tables=torch.tensor([[2, 0], [3, 1]],
                                           dtype=torch.int32),
                       n_pages=torch.full((B,), 2, dtype=torch.int32),
                       write_mask=torch.ones((B,), dtype=torch.bool),
                       max_seq=MAX_SEQ, page_size=16) if pages else None
    S = toks.shape[1]
    lg, _, caches = M.forward(p, {"tokens": mk(toks)}, cfg, caches,
                              mk(np.zeros((B,), np.int32)), last_only=True,
                              paged=pv)
    out = [np.asarray(np_(lg[:, -1]))]
    tok = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
    for i in range(steps):
        lg, caches = M.decode_step(p, mk(tok), cfg, caches,
                                   mk(np.full((B,), S + i, np.int32)),
                                   paged=pv)
        out.append(np.asarray(np_(lg)))
        tok = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
    return np.stack(out), caches


def test_prefill_decode_logits_match_jax(arch_params):
    """The whole 8-layer stack at f32: a 9-token prompt (the sequence path
    from the init state) then 3 decode steps (the step path from the cached
    state), paged: logits and the caches after the run within RTOL_STACK
    of JAX's; the dense layout reproduces the paged logits bit for bit.
    (8 bits: the blocks above and the Engine streams below.)"""
    arch, jp, tp = arch_params
    jc, tc = smoke_pair(arch)
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (B, 9)
                                             ).astype(np.int32)
    a, ca = _decode_run(JM, jc, jp, toks, 3, "paged", jnp.asarray)
    b, cb = _decode_run(TM, tc, tp, toks, 3, "paged", torch.from_numpy)
    np.testing.assert_allclose(b, a, rtol=RTOL_STACK,
                               atol=RTOL_STACK * np.abs(a).max())
    for x, y in zip(tree_leaves(cb), jax.tree_util.tree_leaves(ca)):
        y = np.asarray(y)
        np.testing.assert_allclose(np_(x), y, rtol=RTOL_STACK,
                                   atol=RTOL_STACK * np.abs(y).max())
    dense, _ = _decode_run(TM, tc, tp, toks, 3, "dense", torch.from_numpy)
    np.testing.assert_array_equal(dense, b)


def test_none_ff_block_has_no_norm2_and_no_aux():
    """An `slstm+none` block holds norm1 and the mixer only and adds no
    aux loss (an xlstm forward's aux is 0; jamba's, from its MoE layers,
    is not); parse_spec admits every mixer, `xattn` included, and rejects
    an unknown one."""
    _, tc = smoke_pair(XL)
    p = TT.init_block(torch.Generator().manual_seed(0), tc, "slstm+none",
                      "cpu")
    assert sorted(p) == ["mixer", "norm1"]
    toks = torch.tensor([[1, 2, 3]])
    for arch in (XL, JB):
        _, tc = smoke_pair(arch)
        _, aux, _ = TM.forward(_params(arch)[1], {"tokens": toks}, tc)
        assert (float(aux) > 0) == (arch == JB)
    assert TT.parse_spec("mamba+none") == ("mamba", "none")
    assert TT.parse_spec("xattn+dense") == ("xattn", "dense")
    with pytest.raises(ValueError, match="bad layer spec"):
        TT.parse_spec("conv+dense")


# --- serving trees --------------------------------------------------------------

def test_serving_tree_carried_leaf_for_leaf(arch_params):
    """tree_prepare_serving at 8 bits on both sides (4-bit pair-packing of
    stacked leaves: tests/test_torch_moe.py; xlstm's smoke sLSTM w_down has
    K = 85, which 4 bits cannot pair-pack): every servable linear of the
    mixers (mLSTM w_up/wq/wk/wv/w_down, sLSTM w_gates/w_up/w_down, mamba
    w_in/w_out) equal as values and scales; the recurrence weights (w_if,
    r_gates, w_bc, w_dt_*) and the f32 leaves stay float."""
    arch, jp, tp = arch_params
    q = dict(enabled=True, bits_w=8, bits_a=8)
    jq = to_torch(jbl.tree_prepare_serving(jp, jbl.QuantConfig(**q)))
    tq = tbl.tree_prepare_serving(tp, tbl.QuantConfig(**q))
    jl, tl = leaves(jq), leaves(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    quantized = set()
    for (path, a), (_, b) in zip(jl, tl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            quantized.add(path.split(".")[-1])
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
            assert (a.packed, a.packed_axis, a.bits) == \
                (b.packed, b.packed_axis, b.bits), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    want = {XL: {"w_up", "wq", "wk", "wv", "w_down", "w_gates", "unembed"},
            JB: {"w_in", "w_out", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                 "w_down", "unembed"}}[arch]
    assert quantized == want
    own = TM.init_params(smoke_pair(arch)[1],
                         torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in leaves(own)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in leaves(tp)]


@pytest.mark.parametrize("arch,bits", [(XL, 8), (JB, 4)])
def test_init_params_serving_equals_prepared_tree(arch, bits):
    """init_params(serving=q), which quantizes each period's block as it is
    drawn (MoE stacks drawn expert by expert), equals tree_prepare_serving
    over the float tree from the same seed, leaf for leaf."""
    tc = smoke_pair(arch)[1].replace(num_layers=16)
    q = tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    want = tbl.tree_prepare_serving(
        TM.init_params(tc, torch.Generator().manual_seed(0), "cpu"), q)
    got = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                         serving=q)
    wl, gl = leaves(want), leaves(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(wl, gl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
            assert (a.bits, a.packed, tuple(a.shape)) == \
                (b.bits, b.packed, tuple(b.shape)), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path


# --- the Engine -----------------------------------------------------------------

def _prompts(vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, vocab, int(n))) for n in (5, 9, 3, 7)]


def _serve(engine_cls, cfg, params, prompts, news, **kw):
    extra = {"device": "cpu"} if engine_cls is TEngine else {}
    eng = engine_cls(cfg, params, num_slots=2, max_seq=48, **kw, **extra)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


def test_engine_greedy_streams_equal_jax(arch_params):
    """8-bit greedy streams of four requests on two slots (admissions
    while the other slot decodes, so the admission's masked state write
    must keep the decoding slot's state):
    the port's paged and dense Engines equal the JAX Engine's (paged, no
    prefix cache); both prefill one token per forward; the prefix cache
    (paged) and speculation (dense) requested opt out silently."""
    arch, jp, tp = arch_params
    jc, tc = smoke_pair(arch, quant_bits=8)
    jq = jbl.tree_prepare_serving(jp, jc.quant)
    tq = tbl.tree_prepare_serving(tp, tc.quant)
    prompts, news = _prompts(tc.vocab_size), (6, 3, 5, 2)
    want, jeng = _serve(JEngine, jc, jq, prompts, news, prefix_cache=False)
    assert jeng.prefill_chunk == 1
    runs = {"paged, prefix cache requested": dict(
                prefix_cache=True, prefix_chunk=4, check_invariants=True),
            "dense, speculation requested": dict(kv_layout="dense",
                                                 draft_len=3)}
    for name, kw in runs.items():
        got, eng = _serve(TEngine, tc, tq, prompts, news, **kw)
        assert got == want, name
        assert eng.prefill_chunk == 1 and eng.prefix is None, name
        assert eng.draft_len == 0 and eng.spec_stats()["drafter"] is None
        assert eng.n_admit_calls >= max(len(p) for p in prompts[:2])
        assert eng.kv_layout == "dense" or eng.pages_in_use == 0


@pytest.mark.parametrize("arch", [XL, JB])
def test_reused_slot_starts_from_init_state(arch):
    """As tests/test_serving_engine.py:266: in a one-slot engine, a request
    served after another (and an idle tick) streams as on a fresh
    engine."""
    _, tp = _params(arch)
    _, tc = smoke_pair(arch)
    rng = np.random.default_rng(3)
    pa = list(rng.integers(0, tc.vocab_size, size=6))
    pb = list(rng.integers(0, tc.vocab_size, size=8))

    def run(first):
        eng = TEngine(tc, tp, num_slots=1, max_seq=48, device="cpu")
        if first:
            eng.submit(pa, 5)
            eng.run()
            eng.step()
        r = eng.submit(pb, 4)
        eng.run()
        assert r.done
        return list(r.out_tokens)

    assert run(True) == run(False)


def test_launcher_serves_recurrent_archs(capsys):
    """`--arch xlstm-1.3b` and `--arch jamba-1.5-large-398b --smoke` run on
    the CPU; the report says prompts prefill one token at a time and that
    speculation opts out."""
    for arch in (XL, JB):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--quant-bits", "8", "--requests", "2",
                      "--new-tokens", "2", "--max-seq", "48",
                      "--draft-len", "2"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("2/2 requests done"), out
        assert "prompts prefill one token at a time" in out[2]
        assert "speculation: requested but this arch opts out" in out[3]
        assert "prefix cache: off" in out[-1]
