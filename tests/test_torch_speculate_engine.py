"""Speculative decoding at the Engine level in the port against the JAX
Engine (the module-level parts are in `test_torch_speculate.py`, whose
`base` fixture this file shares; the greedy streams against the JAX
Engine's are in `test_torch_speculate_streams.py`): the
structured-weights acceptance case; stop, budget and max_seq clamping
inside a window; `spec_stats` across `abort`; a mid-window rejection
across a page boundary; the draft cache against a fresh replay (A6); and
the launcher's speculation report line."""
import re

import jax
import numpy as np
import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.tree import tree_map
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import leaves, smoke_pair
from test_torch_engine_features import _launch, _timing_free
from test_torch_speculate import CACHE_ATOL, _t, base  # noqa: F401

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker


# --- the Engine -------------------------------------------------------------

def _structured_params(cfg):
    """Integer-exact weights: layers zero, embedding[t] = onehot(t % d),
    unembed[i, (i+1) % d] = 1, final norm ones — the greedy stream is
    t -> t+1 (mod d) at 8 and at 2 bits alike."""
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = tree_map(torch.zeros_like, params)
    D, V = cfg.d_model, cfg.vocab_size
    emb = torch.zeros((V, D))
    emb[torch.arange(V), torch.arange(V) % D] = 1.0
    unemb = torch.zeros((D, V))
    unemb[torch.arange(D), (torch.arange(D) + 1) % D] = 1.0
    params["embed"]["embedding"] = emb.to(cfg.compute_dtype)
    params["embed"]["unembed"] = unemb.to(cfg.compute_dtype)
    params["final_norm"]["scale"] = torch.ones((D,), dtype=cfg.compute_dtype)
    return params


def test_model_drafter_beats_ngram_on_structured_stream():
    """On a structured, never-repeating stream the n-gram drafter accepts
    nothing and the 2-bit draft model nearly everything: fewer ticks for
    the same stream."""
    _, cfg = smoke_pair()
    params = _structured_params(cfg)
    prompt, n = [1, 2, 3], 20
    expect = [(prompt[-1] + 1 + i) % cfg.d_model for i in range(n)]
    stats, ticks = {}, {}
    for drafter in ("ngram", "model"):
        eng = TEngine(cfg, params, num_slots=1, max_seq=64, draft_len=4,
                      drafter=drafter, device="cpu")
        r = eng.submit(prompt, n)
        eng.run()
        assert r.out_tokens == expect, drafter
        stats[drafter], ticks[drafter] = eng.spec_stats(), eng.n_ticks
    assert stats["ngram"]["accepted"] == 0
    assert stats["model"]["accepted"] >= stats["model"]["drafted"] - 4 > 0
    assert ticks["model"] < ticks["ngram"]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_stop_budget_and_ceiling_inside_window(base, drafter):
    """A3: a stop token inside an accepted run, a budget that is no
    multiple of the window, and a max_seq ceiling crossing the window cut
    the stream where sequential decoding does."""
    _, _, tc, tp = base
    prompt = [5, 9, 5, 9, 5, 9, 5, 9]
    ref_eng = TEngine(tc, tp, num_slots=1, max_seq=64, device="cpu")
    ref = ref_eng.submit(prompt, 24)
    ref_eng.run()
    ref = ref.out_tokens
    stop = ref[len(ref) // 2]

    def spec(max_seq, n, **kw):
        eng = TEngine(tc, tp, num_slots=1, max_seq=max_seq, draft_len=6,
                      drafter=drafter, check_invariants=True, device="cpu")
        r = eng.submit(prompt, n, **kw)
        eng.run()
        return r

    r = spec(64, 24, stop_tokens=(stop,))
    assert r.out_tokens == ref[:ref.index(stop) + 1]
    assert r.result.finish_reason == "eos"
    r = spec(64, 9)
    assert r.out_tokens == ref[:9] and r.result.finish_reason == "budget"
    r = spec(24, 100)
    assert r.out_tokens == ref[:24 - len(prompt)]
    assert r.result.finish_reason == "max_seq"


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_stats_survive_abort(base, drafter):
    _, _, tc, tp = base
    eng = TEngine(tc, tp, num_slots=1, max_seq=64, draft_len=4,
                  drafter=drafter, device="cpu")
    r = eng.submit([5, 9, 5, 9, 5, 9], 40)
    for _ in range(4):
        eng.step()
    st_ = eng.spec_stats()
    assert st_["drafter"] == drafter and st_["drafted"] > 0 and not r.done
    assert eng.abort(r)
    assert eng.spec_stats() == st_
    assert r.result.finish_reason == "aborted"
    assert eng.tokens_drafted == st_["drafted"] == r.result.drafted_tokens
    assert eng.tokens_accepted == st_["accepted"]


def test_stochastic_streams_terminate_count_and_reproduce(base):
    """Rejection sampling in the Engine: every request emits its budget,
    the counters add up, and a request's stream depends on its seed only
    (alone in a fresh engine vs co-batched)."""
    _, _, tc, tp = base
    kw = dict(num_slots=2, max_seq=64, draft_len=4, sampling="top_k",
              top_k=8, temperature=0.8, device="cpu")
    prompt = [7, 3, 7, 3, 7, 3]
    eng = TEngine(tc, tp, check_invariants=True, **kw)
    rs = [eng.submit(prompt, 15, seed=s) for s in (1, 2, 3)]
    results = eng.run()
    assert all(len(r.tokens) == 15 for r in results)
    assert all(0 <= r.accepted_tokens <= r.drafted_tokens for r in results)
    st_ = eng.spec_stats()
    assert st_["drafted"] == sum(r.drafted_tokens for r in results)
    assert st_["accepted"] == sum(r.accepted_tokens for r in results)
    alone = TEngine(tc, tp, **kw)
    r2 = alone.submit(prompt, 15, seed=2)
    alone.run()
    assert r2.result.tokens == rs[1].result.tokens


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_midwindow_rejection_across_a_page_boundary(base, drafter):
    """The first window [ps-2 .. ps+2] crosses the page-0/page-1 boundary;
    after serving, the paged pool equals a non-speculative engine's within
    CACHE_ATOL, and every row the non-speculative pool never wrote is
    exactly zero (rejected rows rolled back)."""
    _, _, tc, tp = base
    ps = tc.page_size
    prompt = list(np.random.default_rng(3).integers(1, tc.vocab_size, ps - 2))

    def engine(**kw):
        eng = TEngine(tc, tp, num_slots=1, max_seq=4 * ps, prefix_cache=False,
                      check_invariants=True, device="cpu", **kw)
        r = eng.submit(prompt, ps + 4)
        eng.run()
        return r.out_tokens, eng

    plain, e0 = engine()
    spec, e1 = engine(draft_len=5, drafter=drafter)
    assert spec == plain
    assert e1.spec_stats()["accepted"] < e1.spec_stats()["drafted"]
    for (path, a), (_, b) in zip(leaves(e0.caches), leaves(e1.caches)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=CACHE_ATOL, err_msg=path)
        assert torch.equal(b[a == 0], a[a == 0]), path


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_draft_cache_matches_stream_replay(base, layout):
    """A6 end to end: after a served request (verify rejects most windows
    mid-draft), the draft cache equals a fresh replay of prompt + emitted
    tokens within CACHE_ATOL, and n_stream / last track the stream
    exactly."""
    _, _, tc, tp = base
    eng = TEngine(tc, tp, num_slots=1, max_seq=64, draft_len=4,
                  drafter="model", kv_layout=layout, device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    r = eng.submit(prompt, 12)
    eng.run()
    stream = prompt + list(r.out_tokens)
    dr = eng.drafter
    fresh = dr.observe(dr.init_state(1, "cpu"), _t(np.asarray([stream],
                                                              np.int32)),
                       torch.ones((1, len(stream)), dtype=torch.bool))
    ds = eng.state.draft
    assert int(ds.n_stream[0]) == len(stream) and int(ds.last[0]) == stream[-1]
    for (path, a), (_, b) in zip(leaves(ds.caches), leaves(fresh.caches)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=CACHE_ATOL, err_msg=path)


def test_draft_len_clamped_and_unported_options(base):
    _, _, tc, tp = base
    eng = TEngine(tc, tp, num_slots=1, max_seq=6, draft_len=9, device="cpu")
    assert eng.draft_len == 4 and eng.spec_stats()["draft_len"] == 4
    assert TEngine(tc, tp, device="cpu").spec_stats() == {
        "enabled": False, "draft_len": 0, "drafter": None, "drafted": 0,
        "accepted": 0, "acceptance_rate": 0.0}
    # the model drafter under a mesh (refused until it was ported)
    with TEngine(tc, tp, mesh="model=1", draft_len=2, drafter="model",
                 device="cpu") as eng:
        assert eng.drafter_kind == "model" and eng.draft_len == 2


@pytest.mark.parametrize("args", [["--draft-len", "4"],
                                  ["--draft-len", "4", "--drafter", "model"]],
                         ids=["ngram", "model"])
def test_launcher_speculation_report_as_the_reference(args, monkeypatch,
                                                      capsys):
    """The port's launcher (CPU subprocess) against the reference's `main`,
    both serving four requests: the same lines apart from wall-time
    readings, the speculation line word for word."""
    args = ["--requests", "4"] + args
    import sys
    from repro.launch import serve as jlaunch
    port = _launch("repro_torch.launch.serve", ["--device", "cpu"] + args)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "granite-8b",
                                      "--smoke"] + args)
    jlaunch.main()
    ref = capsys.readouterr().out.strip().splitlines()
    port[0] = port[0].replace(", device=cpu)", ")")
    # the launchers draw their random weights from different generators, so
    # the counts that follow the streams' acceptance (syncs, drafts, decode
    # steps, and which requests share the pool at once) are masked in those
    # lines; the others are equal as they are
    numbers = re.compile(r"\d+(\.\d+)?")
    by_ticks = ("syncs", "speculation:", "kv reads:", "prefix cache:")
    masked = [[numbers.sub("N", line) if any(w in line for w in by_ticks)
               else line for line in _timing_free(lines)]
              for lines in (port, ref)]
    assert masked[0] == masked[1]
    spec = [line for line in port if line.startswith("  speculation:")]
    assert len(spec) == 1
    assert f"drafter={'model' if 'model' in args else 'ngram'}" in spec[0]
