"""Stochastic sampling in the port (`repro_torch.runtime.sampling`) against
the JAX package's.  The port draws from per-request `torch.Generator`
streams, not JAX's threefry, so the comparison is of distributions, not
bits: over 40 000 draws each token's frequency is within 0.015 (about 6
standard errors) of softmax(JAX `_filter_logits`), and no draw falls
outside its support.  At the Engine level a request's stream depends on
its seed only: not on its slot, its neighbours or `decode_steps`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as jsmp
from repro_torch.runtime import sampling as tsmp
from repro_torch.runtime.serve import Engine
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")

V = 16
DRAWS = 40_000
CONFIGS = {
    "temperature": dict(method="temperature", temperature=0.7),
    "top_k_ties": dict(method="top_k", top_k=5, temperature=1.3),
    "top_p": dict(method="top_p", top_p=0.8, temperature=0.9),
}


def _logits():
    """Seeded (2, V) logits; row 1 ties five values across the top-5
    cutoff, so top-k must keep exactly k by rank."""
    rng = np.random.default_rng(0)
    l = rng.normal(size=(2, V)).astype(np.float32) * 1.5
    l[1, [2, 5, 9, 11, 14]] = l[1].max() - 0.5
    return l


@pytest.mark.parametrize("name", list(CONFIGS))
def test_draws_match_jax_filtered_softmax(name):
    sc = CONFIGS[name]
    logits = _logits()
    want = np.asarray(jax.nn.softmax(jsmp._filter_logits(
        jnp.asarray(logits), jsmp.SamplingConfig(**sc)), axis=-1))
    g = tsmp.request_generator(0, 7, "cpu")
    for row in range(logits.shape[0]):
        rows = torch.from_numpy(np.repeat(logits[row:row + 1], DRAWS, 0))
        toks = tsmp.sample(rows, tsmp.SamplingConfig(**sc),
                           [g] * DRAWS).numpy()
        support = np.flatnonzero(want[row] > 0)
        assert np.isin(toks, support).all(), (name, row)
        freq = np.bincount(toks, minlength=V) / DRAWS
        np.testing.assert_allclose(freq, want[row], atol=0.015,
                                   err_msg=f"{name} row {row}")
    if sc["method"] == "top_k":
        assert (want[1] > 0).sum() == sc["top_k"]


def test_greedy_consumes_no_randomness_and_streams_reproduce():
    logits = torch.from_numpy(_logits())
    g = tsmp.request_generator(3, 11, "cpu")
    before = g.get_state().clone()
    toks = tsmp.sample(logits, tsmp.SamplingConfig(), [g, g])
    assert torch.equal(g.get_state(), before)
    assert toks.tolist() == np.argmax(_logits(), axis=-1).tolist()
    sc = tsmp.SamplingConfig(method="temperature", temperature=2.0)
    a = [tsmp.sample(logits, sc, [g, g]).tolist() for _ in range(20)]
    assert not torch.equal(g.get_state(), before)
    g2 = tsmp.request_generator(3, 11, "cpu")
    b = [tsmp.sample(logits, sc, [g2, g2]).tolist() for _ in range(20)]
    assert a == b
    g3 = tsmp.request_generator(3, 12, "cpu")
    c = [tsmp.sample(logits, sc, [g3, g3]).tolist() for _ in range(20)]
    assert a != c


@pytest.fixture(scope="module")
def smoke_params():
    from repro.models import model as JM
    jc, tc = smoke_pair()
    return tc, to_torch(JM.init_params(jc, jax.random.PRNGKey(0)))


def _sampled(tc, tp, order, seeds, prompts, **kw):
    kw.setdefault("num_slots", 2)
    eng = Engine(tc, tp, max_seq=64, sampling="top_p", top_p=0.9,
                 temperature=0.8, seed=5, device="cpu", **kw)
    reqs = {i: eng.submit(prompts[i], 10, seed=seeds[i]) for i in order}
    eng.run()
    return {i: r.out_tokens for i, r in reqs.items()}


def test_engine_streams_depend_on_the_seed_only(smoke_params):
    """Same seeds: identical streams submitted in order, in reverse order
    (other slots, other neighbours), alone, and with decode_steps 3.
    Seeds + 100: other streams."""
    tc, tp = smoke_params
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, size=int(n))
               for n in (5, 17, 9, 30)]
    seeds = [0, 1, 2, 3]
    fwd = _sampled(tc, tp, range(4), seeds, prompts)
    rev = _sampled(tc, tp, reversed(range(4)), seeds, prompts,
                   decode_steps=3)
    alone = _sampled(tc, tp, [2], seeds, prompts, num_slots=1)
    assert fwd == rev
    assert alone[2] == fwd[2]
    other = _sampled(tc, tp, range(4), [s + 100 for s in seeds], prompts)
    assert sum(other[i] != fwd[i] for i in range(4)) >= 3
    assert all(0 <= t < tc.vocab_size for s in fwd.values() for t in s)
