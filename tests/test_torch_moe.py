"""The MoE feed-forward in the port (`models.moe`, `bramac_linear.
serve_einsum_edf` / `edf_accumulate`, the `+moe` blocks of
`models.transformer`) against the JAX package's, on the qwen3-moe-30b-a3b
and dbrx-132b smoke configs (2 layers, d=64, E=8 top-2 and E=4 top-2,
f32), on the same numpy inputs.

Integer results (ranks in expert, capacities, keep masks, drop counts, the
expert einsum's int32 accumulators and its f32 output) are equal bit for
bit.  Float MoE outputs and aux losses agree within ATOL_MOE, f32
reassociation; quantized outputs and logits within test_torch_model's
ATOL_Q.  At the
Engine level, greedy streams equal the JAX Engine's — paged, dense,
disaggregated and with the prefix cache — at the default capacity, where
tokens are dropped; speculation opts out silently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bramac_linear as jbl
from repro.core import quant as jquant
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.runtime.serve import Engine as JEngine
from repro_torch.core import bramac_linear as tbl
from repro_torch.core import quant as tquant
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import leaves, np_, smoke_pair, to_torch
from test_torch_model import ATOL_Q, _jax_run, _torch_run

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
# f32 MoE layer: the same arithmetic up to reassociation (router matmul,
# softmax sums, expert matmuls) on values of order 1
ATOL_MOE = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    """(arch, JAX float tree, the same tree in the port)."""
    jc, _ = smoke_pair(request.param)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return request.param, jp, to_torch(jp)


_Q8 = {}


def _q8(arch, jp, tp):
    """(jc, tc, JAX 8-bit serving tree, the port's) of `arch_params`'
    trees, quantized once for the module's tests."""
    if arch not in _Q8:
        jc, tc = smoke_pair(arch, quant_bits=8)
        _Q8[arch] = (jc, tc, jbl.tree_prepare_serving(jp, jc.quant),
                     tbl.tree_prepare_serving(tp, tc.quant))
    return _Q8[arch]


def _layer(jp, tp):
    """The first period's MoE parameters on both sides."""
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["pos0"]["moe"])
    pt = {k: (v.map(lambda a: a[0]) if isinstance(v, QuantizedTensor)
              else v[0]) for k, v in tp["layers"]["pos0"]["moe"].items()}
    return pj, pt


def _x(seed, d, B=2, S=16):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _jax_keep(p, x, cfg, cf):
    """The reference's keep mask, from its own routing functions."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.experts_per_token)
    C = JMoE.moe_capacity(xf.shape[0], cfg.num_experts,
                          cfg.experts_per_token, cf)
    pos = JMoE._rank_in_expert_sort(top_i.reshape(-1), cfg.num_experts)
    return np.asarray(pos < C), C


# --- routing bookkeeping (integers, exact) ----------------------------------

@pytest.mark.parametrize("E", [4, 8, 128])
def test_rank_in_expert_equals_jax(E):
    """Both rank-in-expert dispatches equal JAX's and each other."""
    for seed in range(3):
        a = np.random.default_rng(seed).integers(0, E, size=200).astype(
            np.int32)
        want = np.asarray(JMoE._rank_in_expert_sort(jnp.asarray(a), E))
        np.testing.assert_array_equal(
            want, np.asarray(JMoE._rank_in_expert_cumsum(jnp.asarray(a), E)))
        t = torch.from_numpy(a).long()
        for fn in (TMoE._rank_in_expert_sort, TMoE._rank_in_expert_cumsum):
            got = fn(t, E)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(np_(got), want)


def test_moe_capacity_matches():
    for T in (1, 4, 5, 64, 96):
        for E, k in ((4, 2), (8, 2), (16, 4), (128, 8)):
            for cf in (0.5, 1.0, 1.25, 2.0, E / k):
                assert TMoE.moe_capacity(T, E, k, cf) == \
                    JMoE.moe_capacity(T, E, k, cf)


def test_top_k_ties_to_the_lower_index():
    """Equal probabilities rank by index, as jax.lax.top_k ranks them."""
    probs = np.asarray([[0.1, 0.3, 0.3, 0.1, 0.2],
                        [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = TMoE._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(np_(got_v), np.asarray(want_v))


# --- the float layer ----------------------------------------------------------

@pytest.mark.parametrize("cf,dispatch", [(0.5, "sort"), (1.0, "cumsum"),
                                         ("nodrop", "sort")])
def test_moe_matches_jax(arch_params, cf, dispatch):
    """Output and aux within ATOL_MOE at a squeezing capacity, at 1.0 and
    at no-drop (E/k); keep masks and drop counts equal exactly."""
    arch, jp, tp = arch_params
    jc, tc = smoke_pair(arch, moe_dispatch=dispatch)
    pj, pt = _layer(jp, tp)
    cf = jc.num_experts / jc.experts_per_token if cf == "nodrop" else cf
    x = _x(1, jc.d_model)
    a, aux_a = JMoE.moe(pj, jnp.asarray(x), jc, capacity_factor=cf)
    b, aux_b = TMoE.moe(pt, torch.from_numpy(x), tc, capacity_factor=cf)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_MOE)
    np.testing.assert_allclose(float(aux_b), float(aux_a), atol=ATOL_MOE)
    keep, C = _jax_keep(pj, x, jc, cf)
    r = TMoE.route(pt, torch.from_numpy(x).reshape(-1, jc.d_model), tc, cf)
    assert r.C == C
    np.testing.assert_array_equal(np_(r.keep), keep)
    if cf == 0.5:
        assert (~keep).sum() > 0                    # something was dropped


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_moe_equals_reference_no_drop(arch_params, dispatch):
    """moe() == the dense all-experts moe_reference at no-drop capacity,
    on the port's side (the reference's own tolerance)."""
    arch, jp, tp = arch_params
    _, tc = smoke_pair(arch, moe_dispatch=dispatch)
    _, pt = _layer(jp, tp)
    x = torch.from_numpy(_x(2, tc.d_model))
    out, aux = TMoE.moe(pt, x, tc, capacity_factor=tc.num_experts
                        / tc.experts_per_token)
    want = TMoE.moe_reference(pt, x, tc)
    np.testing.assert_allclose(np_(out), np_(want), rtol=2e-3, atol=2e-3)
    assert float(aux) > 0


def test_moe_validates_dispatch(arch_params):
    arch, jp, tp = arch_params
    _, tc = smoke_pair(arch)
    _, pt = _layer(jp, tp)
    x = torch.from_numpy(_x(3, tc.d_model, S=2))
    with pytest.raises(ValueError, match="ep_dispatch"):
        TMoE.moe(pt, x, tc, dispatch="bogus")
    # per_source without a mesh is the dense path, as in the reference
    a, _ = TMoE.moe(pt, x, tc, dispatch="per_source")
    b, _ = TMoE.moe(pt, x, tc, dispatch="global")
    assert torch.equal(a, b)


# --- the quantized expert einsum ----------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_serve_einsum_edf_bit_exact_vs_jax(bits):
    """The int32 accumulators, then the f32 output, equal JAX's bit for bit
    (E=8, C=5, d=64 -> f=48); the plain route equals the kernel route."""
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(8, 5, 64)).astype(np.float32)
    w = rng.normal(size=(8, 64, 48)).astype(np.float32)
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    jq = jbl.prepare_serving(jnp.asarray(w), q)
    tq = to_torch(jq)
    jx = jquant.quantize(jnp.asarray(x), 8, axis=-1)
    tx = tquant.quantize(torch.from_numpy(x), 8, axis=-1)
    assert torch.equal(tx.values, torch.from_numpy(np.asarray(jx.values)))
    acc = tbl.edf_accumulate(tx.values, tq.unpacked_values())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        np_(acc), np.asarray(jbl.edf_accumulate(jx.values,
                                                jq.unpacked_values())))
    want = np.asarray(jbl.serve_einsum_edf(jnp.asarray(x), jq, False))
    got = tbl.serve_einsum_edf(torch.from_numpy(x), tq, False)
    np.testing.assert_array_equal(np_(got), want)
    assert torch.equal(tbl.serve_einsum_edf_plain(torch.from_numpy(x), tq,
                                                  True), got)


def test_quantized_moe_layer_matches_jax(arch_params):
    """The MoE layer on 8-bit serving weights: within ATOL_Q of JAX's
    (the expert einsum alone is bit-exact at 2/4/8 bits, above)."""
    arch, jp, tp = arch_params
    jc, tc = smoke_pair(arch, quant_bits=8)
    pj = jbl.tree_prepare_serving(_layer(jp, tp)[0], jc.quant)
    pt = to_torch(pj)
    x = _x(4, jc.d_model)
    a, _ = JMoE.moe(pj, jnp.asarray(x), jc)
    b, _ = TMoE.moe(pt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(np_(b), np.asarray(a), atol=ATOL_Q)


def test_serving_tree_carried_leaf_for_leaf(arch_params):
    """tree_prepare_serving at 4 bits (packed) on both sides: the 4-D
    expert leaves (periods, E, d, f), the unembed and the attention weights
    equal as values, scales, packing and packed_axis; the f32 router stays
    float.  (8 bits: the Engine test serves both sides' 8-bit trees.)"""
    arch, jp, tp = arch_params
    bits = 4
    q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    jq = to_torch(jbl.tree_prepare_serving(jp, q))
    tq = tbl.tree_prepare_serving(tp, tbl.QuantConfig(enabled=True,
                                                      bits_w=bits,
                                                      bits_a=bits))
    jl, tl = leaves(jq), leaves(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
            assert (a.packed, a.packed_axis, a.bits) == \
                (b.packed, b.packed_axis, b.bits), path
        else:
            assert torch.equal(a, b), path
    router = tq["layers"]["pos0"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert tq["layers"]["pos0"]["moe"]["w_down"].values.ndim == 4
    own = TM.init_params(smoke_pair(arch)[1], torch.Generator().manual_seed(0),
                         "cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in leaves(own)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in leaves(tp)]


@pytest.mark.parametrize("arch,bits", [("qwen3-moe-30b-a3b", 8),
                                       ("qwen3-moe-30b-a3b", 4),
                                       ("dbrx-132b", 2), ("minicpm3-4b", 8),
                                       ("granite-8b", 4)])
def test_init_params_serving_equals_prepared_tree(arch, bits):
    """init_params(serving=q), which quantizes each period's block as it
    is drawn, equals tree_prepare_serving over the float tree from the
    same seed, leaf for leaf (values, scales, shape, packing)."""
    tc = smoke_pair(arch)[1]
    q = tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    want = tbl.tree_prepare_serving(
        TM.init_params(tc, torch.Generator().manual_seed(0), "cpu"), q)
    got = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                         serving=q)
    wl, gl = leaves(want), leaves(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    n_quant = 0
    for (path, a), (_, b) in zip(wl, gl):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            n_quant += 1
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
            assert (a.bits, a.packed, a.packed_axis, tuple(a.shape)) == \
                (b.bits, b.packed, b.packed_axis, tuple(b.shape)), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    assert n_quant > 0


# --- the model ----------------------------------------------------------------

def test_prefill_decode_logits_match_jax(arch_params):
    """Prefill (11-token prompts) then 3 greedy decode steps through the
    whole 8-bit model, paged, at the default capacity: logits within
    ATOL_Q; the dense layout reproduces them bit for bit."""
    jc, tc, jp, tp = _q8(*arch_params)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 11)
                                             ).astype(np.int32)
    a, _ = _jax_run(jc, jp, toks, "paged", 3)
    b, _ = _torch_run(tc, tp, toks, "paged", 3)
    np.testing.assert_allclose(b, a, atol=ATOL_Q)
    dense, _ = _torch_run(tc, tp, toks, "dense", 3)
    np.testing.assert_array_equal(dense, b)


def test_forward_aux_loss_matches_jax(arch_params):
    """The stack sums the blocks' aux losses, as the reference's does."""
    arch, jp, tp = arch_params
    jc, tc = smoke_pair(arch)
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 7)
                                             ).astype(np.int32)
    _, aux_a, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    _, aux_b, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert float(aux_a) > 0
    np.testing.assert_allclose(float(aux_b), float(aux_a), atol=ATOL_MOE)


# --- the Engine -----------------------------------------------------------------

def _waves(vocab):
    """Two waves of two requests behind a shared 20-token stem: each wave
    is submitted together (the two share a forward, so each routes with
    the other's rows and with padding), the second after the first has
    finished (warm prefix admissions, copy-on-write mid-page)."""
    rng = np.random.default_rng(7)
    stem = list(rng.integers(1, vocab, 20))
    return [[(stem + list(rng.integers(1, vocab, 5)), 9),
             (list(rng.integers(1, vocab, 13)), 12)],
            [(stem + list(rng.integers(1, vocab, 3)), 10),
             (stem[:14] + list(rng.integers(1, vocab, 8)), 8)]]


def _serve(engine_cls, cfg, params, waves, **kw):
    extra = {"device": "cpu"} if engine_cls is TEngine else {}
    eng = engine_cls(cfg, params, num_slots=2, max_seq=64, **kw, **extra)
    outs = []
    for wave in waves:
        reqs = [eng.submit(p, n) for p, n in wave]
        eng.run()
        assert all(r.done for r in reqs)
        outs += [list(r.out_tokens) for r in reqs]
    return outs, eng


def test_engine_greedy_streams_equal_jax(arch_params):
    """Greedy streams of the port's 8-bit Engine equal the JAX Engine's
    under the same options at the default capacity (1.25, tokens dropped):
    paged, dense, disaggregated and the prefix cache on; a draft_len=4
    engine opts out of speculation and serves the paged streams."""
    jc, tc, jq, tq = _q8(*arch_params)
    waves = _waves(tc.vocab_size)
    runs = {"paged": dict(prefix_cache=False, check_invariants=True),
            "dense": dict(kv_layout="dense"),
            "disagg": dict(disagg=True, check_invariants=True),
            "prefix": dict(prefix_cache=True, prefix_chunk=8,
                           check_invariants=True)}
    for name, kw in runs.items():
        want, jeng = _serve(JEngine, jc, jq, waves, **kw)
        got, eng = _serve(TEngine, tc, tq, waves, **kw)
        assert got == want, name
        if name == "prefix":
            assert eng.prefix_stats() == jeng.prefix_stats()
            assert eng.prefix_stats()["hits"] >= 2
    spec, eng = _serve(TEngine, tc, tq, waves, draft_len=4,
                       prefix_cache=False)
    assert eng.draft_len == 0 and eng.spec_stats()["drafter"] is None
    assert spec == _serve(TEngine, tc, tq, waves, prefix_cache=False)[0]


def test_engine_capacity_and_dispatch_override():
    """capacity_factor / dispatch override the routing knobs for the
    Engine only; the caller's cfg stays untouched; a bad dispatch raises
    the reference's ValueError."""
    jc, tc = smoke_pair("qwen3-moe-30b-a3b", quant_bits=8)
    tq = tbl.tree_prepare_serving(
        TM.init_params(tc, torch.Generator().manual_seed(0), "cpu"),
        tc.quant)
    with TEngine(tc, tq, num_slots=2, max_seq=32, capacity_factor=2.0,
                 dispatch="per_source", device="cpu") as eng:
        assert eng.cfg.moe_capacity_factor == 2.0
        assert eng.cfg.ep_dispatch == "per_source"
        assert tc.moe_capacity_factor == 1.25 and tc.ep_dispatch == "global"
        reqs = [eng.submit([1, 2, 3], max_new_tokens=3),
                eng.submit([4, 5], max_new_tokens=3)]
        eng.run()
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    with pytest.raises(ValueError, match="dispatch"):
        TEngine(tc, tq, num_slots=1, max_seq=8, dispatch="bogus",
                device="cpu")


def test_launcher_capacity_and_dispatch(capsys):
    """The launcher's --capacity-factor / --dispatch reach the Engine; the
    run reports as usual and speculation reports the MoE opt-out."""
    tlaunch.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                  "--quant-bits", "8", "--requests", "3", "--new-tokens",
                  "3", "--capacity-factor", "2", "--dispatch", "per_source",
                  "--draft-len", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("3/3 requests done")
    assert "speculation: requested but this arch opts out" in out[2]
