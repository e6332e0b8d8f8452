"""Speculative decoding in the port (`repro_torch.runtime.speculate`,
`sampling.spec_verify`, `pages.rollback`, the speculative tick) against the
JAX package's on the same numpy inputs.

Bit for bit: the n-gram tables (keys compared as uint32), their proposals,
greedy `spec_verify`, `requantize` and `tree_requantize_serving` at 2/4/8
bits, and the rollbacks and bounded dense writes on random pools.  Within
a stated tolerance: the 2-bit draft model's caches (its drafts must be
equal), which the reference itself only holds bit-equal across programs of
one shape.  In distribution: stochastic `spec_verify` (A2), by a
chi-square test over 20 000 seeded generators.  For the Engine level
streams with speculation equal the JAX Engine's with speculation and the
port's own without, for both drafters, paged (prefix cache on and off) and
dense, fp and int8 KV; the structured-weights acceptance case; stop,
budget and max_seq clamping inside a window; `spec_stats` across `abort`;
a mid-window rejection across a page boundary; the draft cache against a
fresh replay (A6); and the launcher's speculation report line."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.core import bramac_linear as jbl
from repro.core import quant as jq
from repro.models import attention as jattn
from repro.models import model as JM
from repro.runtime import pages as jpg
from repro.runtime import sampling as jsmp
from repro.runtime import speculate as jspc
from repro_torch.core import bramac_linear as tbl
from repro_torch.core import quant as tq
from repro_torch.models import attention as tattn
from repro_torch.tree import tree_map
from repro_torch.runtime import pages as tpg
from repro_torch.runtime import sampling as tsmp
from repro_torch.runtime import speculate as tspc
from test_torch_convert import leaves, np_, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")

# f32 agreement of draft-cache rows computed by programs of other shapes
# (chunked vs one-shot observe, the port vs the reference): fp32
# reassociation through two layers
CACHE_ATOL = 1e-5


@pytest.fixture(scope="module")
def base():
    jc, tc = smoke_pair()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, to_torch(jp)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _ngram_equal(jds, tds):
    assert np.array_equal(np_(tds.keys).astype(np.uint32), np.asarray(jds.keys))
    assert np.array_equal(np_(tds.nexts), np.asarray(jds.nexts))
    assert np.array_equal(np_(tds.hist), np.asarray(jds.hist))


# --- the n-gram drafter (A5) ------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 40),
       ngram=st.integers(2, 4), table=st.sampled_from([8, 64]))
def test_ngram_tables_and_proposals_equal_jax(seed, n, ngram, table):
    """Three slots observe random streams under random masks (table=8
    forces bucket collisions, so last-write-wins decides what lands), in
    two windows; tables, histories and 4-token proposals equal JAX's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 50, size=(3, n)).astype(np.int32)
    mask = rng.random((3, n)) < 0.8
    jd, td = jspc.NGramDrafter(ngram, table), tspc.NGramDrafter(ngram, table)
    jds, tds = jd.init_state(3), td.init_state(3)
    cut = n // 2
    for sl in (slice(0, cut), slice(cut, n)):
        jds = jd.observe(jds, jnp.asarray(toks[:, sl]), jnp.asarray(mask[:, sl]))
        tds = td.observe(tds, _t(toks[:, sl]), _t(mask[:, sl]))
        _ngram_equal(jds, tds)
    assert np.array_equal(np_(td.propose(tds, 4)),
                          np.asarray(jd.propose(jds, 4)))


def test_ngram_reset_clears_exactly_the_masked_slots():
    toks = np.asarray([[3, 4, 5], [3, 9, 5]], np.int32)
    mask = np.asarray([[True, True, True], [True, False, True]])
    reset = np.asarray([True, False])
    jd, td = jspc.NGramDrafter(2, 16), tspc.NGramDrafter(2, 16)
    jds = jd.reset(jd.observe(jd.init_state(2), jnp.asarray(toks),
                              jnp.asarray(mask)), jnp.asarray(reset))
    tds = td.reset(td.observe(td.init_state(2), _t(toks), _t(mask)),
                   _t(reset))
    _ngram_equal(jds, tds)
    assert not np_(tds.keys)[0].any() and np_(tds.hist)[0].tolist() == [-1]


# (t + 1) wraps to the FNV-1a offset basis in uint32, so the one-token
# context [ZERO_TOK] hashes to exactly 0 — the empty-bucket sentinel
ZERO_TOK = -2128831036


def test_ngram_zero_hash_context():
    """The zero-hash context misses an empty table (repeat-last fallback,
    never the phantom token 0), and an insert under it round-trips with its
    key stored as 0 | 1 — as in the reference."""
    ctx = np.asarray([[ZERO_TOK], [7]], np.int32)
    assert np.array_equal(np_(tspc.ngram_hash(_t(ctx))).astype(np.uint32),
                          np.asarray(jspc.ngram_hash(jnp.asarray(ctx))))
    assert int(tspc.ngram_hash(_t(ctx))[0]) == 0
    td = tspc.NGramDrafter(2, 16)
    ds = td.init_state(1)._replace(hist=_t(ctx[:1]))
    assert td.propose(ds, 3).tolist() == [[ZERO_TOK] * 3]
    ds = td.observe(ds, _t(np.asarray([[42]], np.int32)),
                    torch.ones((1, 1), dtype=torch.bool))
    assert int(ds.keys[0, 0]) == 1
    assert td.propose(ds._replace(hist=_t(ctx[:1])), 1).tolist() == [[42]]


# --- the accept rule (sampling.spec_verify) ---------------------------------

def test_greedy_verify_bit_equal_to_jax():
    """`out` and `n_acc` equal JAX's, ties included (first index wins on
    both sides), and every emitted token is the argmax of its row."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5, 32)).astype(np.float32)
    logits[0, :, 3] = logits[0, :, 9] = logits[0].max() + 1   # ties
    t = np.argmax(logits, axis=-1)
    drafts = np.where(rng.random((6, 4)) < 0.6, t[:, :4],
                      rng.integers(0, 32, (6, 4))).astype(np.int32)
    j_out, j_n, _ = jsmp.spec_verify(jnp.asarray(logits), jnp.asarray(drafts),
                                     jnp.zeros((6, 2), jnp.uint32),
                                     jsmp.SamplingConfig())
    t_out, t_n = tsmp.spec_verify(_t(logits), _t(drafts),
                                  tsmp.SamplingConfig())
    assert np.array_equal(np_(t_out), np.asarray(j_out))
    assert np.array_equal(np_(t_n), np.asarray(j_n))
    assert np.array_equal(np_(t_out), t)
    assert t_out.dtype == t_n.dtype == torch.int32


def _gens(n, base=0):
    return [tsmp.request_generator(base, i, "cpu") for i in range(n)]


def test_stochastic_verify_edge_probabilities():
    """A draft holding ~all the mass is always accepted; a draft with zero
    mass is never accepted and never re-emitted by the replacement draw."""
    B, L, V = 3, 4, 16
    sc = tsmp.SamplingConfig(method="temperature", temperature=1.0)
    sure = np.full((B, L, V), -30.0, np.float32)
    sure[..., 7] = 30.0
    out, n_acc = tsmp.spec_verify(_t(sure), torch.full((B, L - 1), 7), sc,
                                  _gens(B))
    assert (n_acc == L - 1).all() and (out == 7).all()
    logits = np.random.default_rng(1).normal(size=(B, L, V)).astype(np.float32)
    logits[..., 3] = -np.inf
    out, n_acc = tsmp.spec_verify(_t(logits), torch.full((B, L - 1), 3), sc,
                                  _gens(B))
    assert (n_acc == 0).all() and not (out == 3).any()


# chi-square critical value at p = 0.001 with 7 degrees of freedom
CHI2_7_999 = 24.322


@pytest.mark.parametrize("method", ["temperature", "top_p"])
def test_stochastic_verify_marginals_chi_square(method):
    """A2: over 20 000 request generators, the token emitted at window
    index 0 is distributed as p_0 (softmax of JAX's filtered logits), and
    the token at index 1, among windows that accepted draft 0, as p_1 —
    whether the draft there was accepted or replaced."""
    N, V = 20_000, 8
    sc = dict(method=method, temperature=0.9, top_p=0.97)
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, V)) * 1.2).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jsmp._filter_logits(
        jnp.asarray(logits), jsmp.SamplingConfig(**sc)), axis=-1))
    drafts = np.asarray([int(np.argsort(p[0])[-2]), int(np.argmax(p[1]))])
    out, n_acc = tsmp.spec_verify(
        _t(np.repeat(logits[None], N, 0)),
        _t(np.repeat(drafts[None], N, 0).astype(np.int32)),
        tsmp.SamplingConfig(**sc), _gens(N, base=3))
    out, n_acc = np_(out), np_(n_acc)
    for i, rows in ((0, np.ones(N, bool)), (1, n_acc >= 1)):
        support = p[i] > 0
        toks = out[rows, i]
        assert support[toks].all()
        obs = np.bincount(toks, minlength=V)[support]
        exp = p[i][support] * rows.sum()
        stat = float(((obs - exp) ** 2 / exp).sum())
        # fewer categories (top_p) only lowers the critical value
        assert stat < CHI2_7_999, (method, i, stat)
    assert 0.05 < (n_acc >= 1).mean() < 0.95   # both branches exercised


# --- rollback and bounded dense writes --------------------------------------

def _pool_leaves(rng, n_periods, lead, rows):
    return {"k": rng.normal(size=(n_periods, lead, rows, 2, 3)).astype(
                np.float32),
            "ks": rng.random((n_periods, lead, rows, 2)).astype(np.float32)}


def _jcaches(c):
    return {"pos0": {k: jnp.asarray(v) for k, v in c.items()}}


def _tcaches(c):
    return {"pos0": {k: torch.from_numpy(v.copy()) for k, v in c.items()}}


def _caches_equal(tc, jc):
    for k in tc["pos0"]:
        np.testing.assert_array_equal(tc["pos0"][k].numpy(),
                                      np.asarray(jc["pos0"][k]), k)


@pytest.mark.parametrize("seed", range(4))
def test_paged_rollback_equals_jax(seed):
    """Random block tables, page counts, write masks, ownership, bounds and
    rejected positions (kept rows routed to max_seq, as the tick does)."""
    rng = np.random.default_rng(seed)
    S, mp, ps, P, L = 3, 4, 4, 10, 5
    max_seq = mp * ps
    caches = _pool_leaves(rng, 2, P, ps)
    tables = rng.integers(0, P, (S, mp)).astype(np.int32)
    n_pages = rng.integers(0, mp + 1, S).astype(np.int32)
    wm = rng.random(S) < 0.8
    owned = rng.random((S, mp)) < 0.7
    bound = rng.integers(0, max_seq + 2, S).astype(np.int32) \
        if seed % 2 else None
    pos = rng.integers(0, max_seq - L + 1, S)[:, None] + np.arange(L)
    pos = np.where(rng.random((S, L)) < 0.3, max_seq, pos).astype(np.int32)
    jpv = jattn.PagedKV(jnp.asarray(tables), jnp.asarray(n_pages),
                        jnp.asarray(wm), max_seq, ps, jnp.asarray(owned),
                        None if bound is None else jnp.asarray(bound))
    tpv = tattn.PagedKV(_t(tables), _t(n_pages), _t(wm), max_seq, ps,
                        _t(owned), None if bound is None else _t(bound))
    flags = {"pos0": {"k": True, "ks": True}}
    want = jpg.rollback(_jcaches(caches), flags, jpv, jnp.asarray(pos))
    got = _tcaches(caches)
    tpg.rollback(got, flags, tpv, _t(pos))
    _caches_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_dense_rollback_and_bounded_update_equal_jax(seed):
    rng = np.random.default_rng(seed)
    S, max_seq, L = 4, 12, 5
    caches = _pool_leaves(rng, 2, S, max_seq)
    wm = rng.random(S) < 0.75
    pos = rng.integers(0, max_seq, S)[:, None] + np.arange(L)
    pos = np.where(rng.random((S, L)) < 0.3, max_seq, pos).astype(np.int32)
    flags = {"pos0": {"k": True, "ks": False}}
    want = jspc.rollback_dense(_jcaches(caches), flags, jnp.asarray(pos),
                               jnp.asarray(wm), max_seq)
    got = _tcaches(caches)
    tspc.rollback_dense(got, flags, _t(pos), _t(wm), max_seq)
    _caches_equal(got, want)
    # dense_update with a bound: negative, past-max_seq and past-bound rows
    # drop; positions distinct within a row (no duplicate kept targets)
    pos = np.stack([rng.permutation(max_seq + 4)[:L] - 2 for _ in range(S)])
    pos = pos.astype(np.int32)
    bound = rng.integers(0, max_seq + 1, S).astype(np.int32)
    cache = rng.normal(size=(S, max_seq, 2, 3)).astype(np.float32)
    new = rng.normal(size=(S, L, 2, 3)).astype(np.float32)
    want = jattn.dense_update(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(pos), jattn.DenseKV(
                                  jnp.asarray(wm), max_seq,
                                  jnp.asarray(bound)))
    got = tattn.dense_update(_t(cache.copy()), _t(new), _t(pos),
                             tattn.DenseKV(_t(wm), max_seq, _t(bound)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- requantization ---------------------------------------------------------

def _qt_equal(t, j, what):
    assert (t.bits, t.packed, tuple(t.shape), t.packed_axis) == \
        (j.bits, j.packed, tuple(j.shape), j.packed_axis), what
    np.testing.assert_array_equal(np_(t.values), np.asarray(j.values), what)
    np.testing.assert_array_equal(np_(t.scale), np.asarray(j.scale), what)


@pytest.mark.parametrize("src_bits", [8, 4])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_requantize_bit_equal_to_jax(src_bits, bits):
    """8-bit and 4-bit (pair-packed) weights requantized to 2/4/8 bits with
    prepare_serving's layout: values and scales bit-equal."""
    w = np.random.default_rng(bits).normal(size=(64, 24)).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), src_bits, axis=0, pack=src_bits < 8,
                      pack_axis=-2)
    tqt = tq.quantize(_t(w), src_bits, axis=0, pack=src_bits < 8,
                      pack_axis=-2)
    _qt_equal(tqt, jqt, "source")
    kw = dict(axis=0, pack=bits < 8, pack_axis=-2)
    _qt_equal(tq.requantize(tqt, bits, **kw), jq.requantize(jqt, bits, **kw),
              f"{src_bits} -> {bits}")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tree_requantize_serving_bit_equal_to_jax(base, bits):
    """The smoke tree, from float and from its 8-bit serving tree (stacked
    per-period leaves included), requantized on both sides."""
    _, jp, _, tp = base
    q8j = jbl.QuantConfig(enabled=True, bits_w=8, bits_a=8)
    q8t = tbl.QuantConfig(enabled=True, bits_w=8, bits_a=8)
    qj = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    qt = tbl.QuantConfig(enabled=True, bits_w=bits, bits_a=bits)
    for jsrc, tsrc in ((jp, tp), (jbl.tree_prepare_serving(jp, q8j),
                                  tbl.tree_prepare_serving(tp, q8t))):
        jl = leaves(to_torch(jbl.tree_requantize_serving(jsrc, qj)))
        tl = leaves(tbl.tree_requantize_serving(tsrc, qt))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        n_q = 0
        for (path, a), (_, b) in zip(jl, tl):
            if isinstance(a, tq.QuantizedTensor):
                n_q += 1
                assert (a.bits, a.packed, a.shape) == (b.bits, b.packed,
                                                       b.shape), path
                assert torch.equal(a.values, b.values), path
                assert torch.equal(a.scale, b.scale), path
            else:
                assert torch.equal(a, b), path
        assert n_q == 8


# --- the model drafter (A6) -------------------------------------------------

@pytest.fixture(scope="module")
def drafters(base):
    jc, jp, tc, tp = base
    return (jspc.QuantDrafter.build(jc, jp, 32, bits=2, draft_layers=None),
            tspc.QuantDrafter.build(tc, tp, 32, bits=2, draft_layers=None))


def _cache_close(tcaches, jcaches, atol=CACHE_ATOL):
    for (path, a), (_, b) in zip(leaves(jax.tree_util.tree_map(np.asarray,
                                                               jcaches)),
                                 leaves(tcaches)):
        np.testing.assert_allclose(np_(b), a, rtol=0, atol=atol,
                                   err_msg=path)


def test_quant_drafter_observe_propose_equal_jax(drafters):
    """Two slots observe streams of different lengths (a left-contiguous
    mask), then both sides propose 4 greedy drafts: drafts, n_stream and
    last equal; caches within CACHE_ATOL."""
    jd, td = drafters
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, size=(2, 9)).astype(np.int32)
    mask = np.arange(9)[None] < np.asarray([[9], [5]])
    jds = jd.observe(jd.init_state(2), jnp.asarray(toks), jnp.asarray(mask))
    tds = td.observe(td.init_state(2, "cpu"), _t(toks), _t(mask))
    assert np.array_equal(np_(tds.n_stream), np.asarray(jds.n_stream))
    assert np.array_equal(np_(tds.last), np.asarray(jds.last))
    _cache_close(tds.caches, jds.caches)
    assert np.array_equal(np_(td.propose(tds, 4)),
                          np.asarray(jd.propose(jds, 4)))


def test_propose_leaves_the_draft_cache_unchanged(drafters):
    """A6 in the port's in-place caches: the rows propose's draft steps
    write are put back, bit for bit — even at max_seq, where the last
    steps drop, and for a slot never observed (n_stream 0)."""
    _, td = drafters
    toks = np.random.default_rng(3).integers(0, 256, (3, 30)).astype(np.int32)
    mask = np.arange(30)[None] < np.asarray([[30], [4], [0]])
    tds = td.observe(td.init_state(3, "cpu"), _t(toks), _t(mask))
    before = [v.clone() for _, v in leaves(tds.caches)]
    g = td.propose(tds, 4)
    assert g.shape == (3, 4) and g.dtype == torch.int32
    assert torch.equal(g, td.propose(tds, 4))
    for b, (path, a) in zip(before, leaves(tds.caches)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_drafter_reset_equals_never_observed(drafters, kind):
    td = tspc.NGramDrafter(2, 32) if kind == "ngram" else drafters[1]
    toks = _t(np.asarray([[5, 6, 7, 8, 9], [11, 12, 13, 14, 15]], np.int32))
    mask = _t(np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool))
    ds = td.reset(td.observe(td.init_state(2, "cpu"), toks, mask),
                  _t(np.asarray([True, False])))
    fresh = td.observe(td.init_state(2, "cpu"), toks,
                       mask & _t(np.asarray([[False], [True]])))
    for (path, a), (_, b) in zip(leaves(dict(ds._asdict())),
                                 leaves(dict(fresh._asdict()))):
        assert torch.equal(a, b), path


def test_chunked_observe_matches_one_shot_replay(drafters):
    """A6 at the drafter level, within CACHE_ATOL (the reference asserts
    bit-equality here and fails it on its own backend): the cache is a
    function of the verified stream, not of how it was chunked."""
    _, td = drafters
    toks = np.random.default_rng(4).integers(0, 50, 17).astype(np.int32)
    one = td.observe(td.init_state(1, "cpu"), _t(toks[None]),
                     torch.ones((1, 17), dtype=torch.bool))
    two = td.init_state(1, "cpu")
    for piece in (toks[:6], toks[6:11], toks[11:]):
        two = td.observe(two, _t(piece[None]),
                         torch.ones((1, len(piece)), dtype=torch.bool))
    assert int(two.n_stream[0]) == 17 and int(two.last[0]) == toks[-1]
    for (path, a), (_, b) in zip(leaves(one.caches), leaves(two.caches)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=CACHE_ATOL, err_msg=path)
