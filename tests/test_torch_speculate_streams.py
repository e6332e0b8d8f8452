"""Speculative decoding's greedy streams at the Engine level in the port
against the JAX Engine (split from `test_torch_speculate_engine.py` so
that `--dist loadfile` gives these six cases a worker of their own; the
`base` fixture is `test_torch_speculate.py`'s): streams with speculation
equal the JAX Engine's with speculation and the port's own without, for
both drafters, paged (prefix cache on and off) and dense, fp and int8 KV
and minicpm3-4b's MLA."""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.runtime.serve import Engine as JEngine
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import smoke_pair, to_torch
from test_torch_speculate import base  # noqa: F401

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker


# --- the Engine -------------------------------------------------------------

def _jobs(vocab, drafter):
    """Repetitive prompts behind a shared 16-token system prefix, so the
    n-gram drafter accepts and the prefix cache shares pages.  The model
    drafter, whose checks count drafts and not acceptance, takes half the
    new tokens (two to three windows a request)."""
    rng = np.random.default_rng(0)
    sys_p = list(rng.integers(1, vocab, 16))
    div = 2 if drafter == "model" else 1
    return [(sys_p + list(rng.integers(1, vocab, 4)) * 3, 20 // div),
            (sys_p + list(rng.integers(1, vocab, 5)) * 2, 18 // div),
            (sys_p + list(rng.integers(1, vocab, 4)) * 3, 16 // div)]


def _serve(engine_cls, cfg, params, jobs, **kw):
    """Staggered submissions (each served to completion before the next),
    so slot reuse, drafter resets and warm prefix admissions all happen."""
    extra = {"device": "cpu"} if engine_cls is TEngine else {}
    eng = engine_cls(cfg, params, num_slots=2, max_seq=64,
                     check_invariants=True, **kw, **extra)
    outs = []
    for prompt, n in jobs:
        r = eng.submit(prompt, n)
        eng.run()
        assert r.done
        outs.append(list(r.out_tokens))
    return outs, eng


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("arch", ["gqa", "int8kv", "mla"])
def test_engine_greedy_streams_equal_jax_and_non_speculative(base, arch,
                                                             drafter):
    """A1: the port with speculation == the JAX Engine with speculation ==
    the port without, over {paged + prefix cache, paged, dense}; the
    n-gram drafter's drafted/accepted counts equal the reference's too.
    `mla` is minicpm3-4b's smoke config with its own weights."""
    _, jp, _, tp = base
    if arch == "mla":
        jc, tc = smoke_pair("minicpm3-4b")
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        tp = to_torch(jp)
    else:
        over = {"quant_kv": True} if arch == "int8kv" else {}
        jc, tc = smoke_pair(**over)
    jobs = _jobs(tc.vocab_size, drafter)
    plain, _ = _serve(TEngine, tc, tp, jobs, kv_layout="dense")
    jspec, jeng = _serve(JEngine, jc, jp, jobs, draft_len=4, drafter=drafter)
    assert jspec == plain
    for kw in ({"kv_layout": "paged", "prefix_cache": True},
               {"kv_layout": "paged", "prefix_cache": False},
               {"kv_layout": "dense"}):
        outs, eng = _serve(TEngine, tc, tp, jobs, draft_len=4,
                           drafter=drafter, **kw)
        assert outs == plain, kw
        st_ = eng.spec_stats()
        assert st_["enabled"] and st_["drafter"] == drafter
        assert st_["drafted"] > 0 and not eng.decode_kernel
        if drafter == "ngram":
            assert st_ == jeng.spec_stats(), kw
            assert st_["accepted"] > 0
            assert eng.n_syncs == jeng.n_syncs, kw
        else:
            assert eng.prefix is None     # the model drafter opts out
