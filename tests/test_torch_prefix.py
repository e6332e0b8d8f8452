"""Copy-on-write prefix caching in the port's Engine against the JAX
package's Engine on the same inputs (the smoke config, numpy prompts from a
seed).

Greedy streams must be identical across {prefix cache on, off} x {paged,
dense} x {fp KV, int8 KV, 8-bit weights, MLA}, prompts that diverge from a
cached prefix mid-page included (the copy-on-write split).  The host
bookkeeping must equal the reference's exactly: `prefix_stats()`, the
high-water marks, every RequestResult's counters and the final HostPool
refcounts, tables and ownership.  Then the reference's own prefix-cache
cases (tests/test_prefix_cache.py), each run through both engines.  Every
paged engine here runs with `check_invariants=True`, so each sync also
re-proves mirror == device allocator."""
import functools

import jax
import numpy as np
import pytest

from repro.core import bramac_linear as jbl
from repro.models import model as JM
from repro.runtime.serve import Engine as JEngine
from repro_torch.core import bramac_linear as tbl
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")

# "mla" is minicpm3-4b's smoke config, with its own weights
VARIANTS = {"fp": {}, "int8_kv": {"quant_kv": True}, "quant8": {"quant_bits": 8},
            "mla": {"arch": "minicpm3-4b"}}


@pytest.fixture(scope="module")
def base():
    jc, _ = smoke_pair()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


@functools.lru_cache(maxsize=None)
def _arch_params(arch):
    jc, _ = smoke_pair(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


def _pair(base, variant="fp"):
    """(JAX cfg, JAX params, port cfg, port params) of one variant."""
    jp, tp = base
    over = dict(VARIANTS[variant])
    arch = over.pop("arch", "granite-8b")
    if arch != "granite-8b":
        jp, tp = _arch_params(arch)
    jc, tc = smoke_pair(arch, **over)
    if over.get("quant_bits"):
        jp = jbl.tree_prepare_serving(jp, jc.quant)
        tp = tbl.tree_prepare_serving(tp, tc.quant)
    return jc, jp, tc, tp


def snapshot(eng, results=()):
    """Everything the host decided: telemetry, pool state, results."""
    snap = {"prefix": eng.prefix_stats(), "n_syncs": eng.n_syncs,
            "n_admit_calls": eng.n_admit_calls, "n_ticks": eng.n_ticks,
            "results": [(r.uid, r.tokens, r.finish_reason, r.prefill_tokens,
                         r.pages_shared) for r in results]}
    if eng.kv_layout == "paged":
        snap.update(
            high_water=eng.pages_high_water,
            shared_high_water=eng.pages_shared_high_water,
            in_use=eng.pages_in_use, refs=eng.pool.refs.tolist(),
            tables=[list(t) for t in eng.pool.slot_tables],
            owned=[list(o) for o in eng.pool.slot_owned])
    return snap


def both(base, script, variant="fp", **kw):
    """Run `script(engine, Engine-is-port)` on the JAX Engine and on the
    port's; returns the two (script output, snapshot) pairs."""
    jc, jp, tc, tp = _pair(base, variant)
    out = []
    for port, (cfg, params) in ((False, (jc, jp)), (True, (tc, tp))):
        extra = {"device": "cpu"} if port else {}
        eng = (TEngine if port else JEngine)(cfg, params, **kw, **extra)
        res = script(eng)
        out.append((res, snapshot(eng, res.get("results", ()))))
    return out


def _staggered(prompts, news, waves):
    """Requests submitted wave by wave, each wave served to completion
    before the next arrives (a producer registers before its consumers
    look; same-round requests never match each other)."""
    def script(eng):
        results, streams = [], []
        for wave in waves:
            reqs = [eng.submit(prompts[i], news[i]) for i in wave]
            results += eng.run()
            streams += [r.out_tokens for r in reqs]
        return {"streams": streams, "results": results}
    return script


def _prompts(vocab):
    """A 40-token system prompt (2.5 pages) shared by warm requests, one
    prompt that leaves it after 28 tokens (its match, 24 tokens at
    prefix_chunk 8, ends mid-page), and a cold one."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, vocab, size=40)
    tail = lambda n: rng.integers(0, vocab, size=n)  # noqa: E731
    return [np.concatenate([sysp, tail(3)]), np.concatenate([sysp, tail(7)]),
            np.concatenate([sysp[:28], tail(9)]), tail(21),
            np.concatenate([sysp, tail(5)]), np.concatenate([sysp, tail(12)])]


NEWS = (5, 4, 6, 3, 5, 4)
WAVES = ([0], [1], [2], [3], [4, 5])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streams_and_host_bookkeeping_equal_jax(base, variant):
    jc, _ = smoke_pair()
    prompts = _prompts(jc.vocab_size)
    script = _staggered(prompts, NEWS, WAVES)
    (jr, js), (tr, ts) = both(base, script, variant, num_slots=2, max_seq=96,
                              prefix_chunk=8, check_invariants=True)
    assert tr["streams"] == jr["streams"]
    assert ts == js
    st = ts["prefix"]
    # 1 and 4 and 5 match 40 tokens (2 full pages + a copy-on-write page),
    # 2 matches 24 (1 full page + a copy-on-write page), 3 misses
    assert (st["hits"], st["misses"], st["tokens_skipped"]) == \
        (4, 2, 3 * 40 + 24)
    assert ts["shared_high_water"] >= 2
    assert [r[4] for r in ts["results"]] == [0, 2, 1, 0, 2, 2]
    cold, cold_s = both(base, script, variant, num_slots=2, max_seq=96,
                        prefix_cache=False, check_invariants=True)
    assert cold[1] == cold_s[1]
    assert cold_s[0]["streams"] == jr["streams"]
    for prefix_cache in (True, False):
        eng = TEngine(*_pair(base, variant)[2:], num_slots=2, max_seq=96,
                      kv_layout="dense", prefix_cache=prefix_cache,
                      device="cpu")
        assert script(eng)["streams"] == jr["streams"]
        assert eng.prefix is None and eng.pool is None
        assert eng.prefix_stats()["enabled"] is False


def test_refcount_zero_reclaim_under_pressure(base):
    """A 4-page pool stays serviceable: slot releases and LRU chain
    eviction both recycle pages at refcount zero."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=20) for _ in range(5)]

    def script(eng):
        reqs = [eng.submit(p, 6) for p in prompts]
        results = eng.run()
        assert all(r.done for r in reqs)
        return {"results": results}

    (_, js), (_, ts) = both(base, script, num_slots=2, max_seq=64,
                            num_pages=4, check_invariants=True)
    assert ts == js
    assert ts["in_use"] == ts["prefix"]["cached_pages"]
    assert ts["high_water"] <= 4 and all(not t for t in ts["tables"])


def test_eviction_preferred_over_stall(base):
    """Pool dry with idle cached prefixes: admission evicts them (LRU)
    rather than stall."""
    def script(eng):
        a = eng.submit(list(range(1, 30)), max_new_tokens=4)
        results = eng.run()
        cached = eng.prefix.cached_pages
        b = eng.submit(list(range(200, 250)), max_new_tokens=8)
        results += eng.run()
        assert a.done and b.done
        return {"results": results, "cached": cached}

    (jr, js), (tr, ts) = both(base, script, num_slots=2, max_seq=64,
                              num_pages=4, check_invariants=True)
    assert ts == js and tr["cached"] == jr["cached"] >= 1
    assert ts["prefix"]["evictions"] >= 1


def test_failed_admission_eviction_does_not_leak(base):
    """An eviction round that still admits nothing commits its refcount
    decrements anyway (`apply_refs_delta`); the queued request admits once
    the long-lived one drains, and stats count one miss per admission."""
    def script(eng):
        rng = np.random.default_rng(5)
        a = eng.submit(rng.integers(0, 256, size=20), 25)
        c = eng.submit(rng.integers(0, 256, size=17), 2)
        while not c.done:
            eng.step()
        b = eng.submit(rng.integers(0, 256, size=50), 8)
        eng.step()                  # the eviction-only round
        mid = (eng.prefix.evictions, b.done, eng.pool.refs.tolist())
        results = eng.run()
        assert a.done and b.done
        return {"results": results, "mid": mid}

    (jr, js), (tr, ts) = both(base, script, num_slots=2, max_seq=64,
                              num_pages=6, check_invariants=True)
    assert ts == js and tr["mid"] == jr["mid"]
    assert tr["mid"][0] >= 1 and not tr["mid"][1]
    assert ts["in_use"] == ts["prefix"]["cached_pages"]
    assert (ts["prefix"]["misses"], ts["prefix"]["hits"]) == (3, 0)


def test_registry_capacity_cap(base):
    """`prefix_max_chains` bounds the registry: registration evicts LRU
    chains past the cap, in lockstep with the device."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=36) for _ in range(6)]

    def script(eng):
        for p in prompts:
            eng.submit(p, 4)
        results = eng.run()
        return {"results": results, "chains": len(eng.prefix.chains)}

    (jr, js), (tr, ts) = both(base, script, num_slots=2, max_seq=64,
                              prefix_max_chains=2, check_invariants=True)
    assert ts == js and tr["chains"] == jr["chains"] <= 2
    assert ts["prefix"]["evictions"] >= 1
    assert ts["in_use"] == ts["prefix"]["cached_pages"]


@pytest.mark.parametrize("on", [True, False])
def test_high_water_strictly_below_cold_with_coresident_sharers(base, on):
    """4 co-resident requests sharing a 32-token prefix: the warm pool's
    high-water is strictly below four private copies; the cold one is
    exactly four."""
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, 256, size=32)
    prompts = [np.concatenate([sysp, rng.integers(0, 256, size=6)])
               for _ in range(4)]
    per_req = -(-(38 + 16 - 1) // 16)

    def script(eng):
        first = eng.submit(prompts[0], 16)      # the producer registers alone
        eng.step()
        rest = [eng.submit(p, 16) for p in prompts[1:]]
        results = eng.run()
        return {"results": results,
                "streams": [first.out_tokens] + [r.out_tokens for r in rest]}

    (jr, js), (tr, ts) = both(base, script, num_slots=4, max_seq=64,
                              prefix_cache=on, check_invariants=True)
    assert ts == js and tr["streams"] == jr["streams"]
    if on:
        assert ts["high_water"] < 4 * per_req
        assert ts["shared_high_water"] >= 2
    else:
        assert ts["high_water"] == 4 * per_req
