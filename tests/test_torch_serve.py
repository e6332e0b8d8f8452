"""The port's serving Engine vs the JAX package's greedy reference loop
(exact-length prefill + one decode per token) on the staggered-admission
parity case of tests/test_serving_engine.py: token streams identical, for
fp KV, int8 KV and 8-bit BRAMAC weights.  Plus the Engine's own contracts:
decode_steps fusion, kernel on/off, page reclaim, admission-time EOS, the
max_seq clamp, and NotImplementedError for options not ported yet.  These
engines run without the prefix cache (tests/test_torch_prefix.py covers
it), so every page returns to the pool when the queue drains."""
import jax
import numpy as np
import pytest
import torch

from repro.core import bramac_linear as jbl
from repro.models import model as JM
from repro_torch.core import bramac_linear as tbl
from repro_torch.runtime.options import EngineOptions, SamplingConfig
from repro_torch.runtime.serve import Engine, resolve_device
from test_serving_engine import reference_greedy
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

LENS = (3, 16, 17, 29, 40)
NEWS = (5, 1, 7, 4, 6)
MAX_SEQ = 64
VARIANTS = {"fp": {}, "int8_kv": {"quant_kv": True}, "quant8": {"quant_bits": 8}}


@pytest.fixture(scope="module")
def base():
    jc, _ = smoke_pair()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab_size, size=n) for n in LENS]
    return jp, to_torch(jp), prompts


def _variant(base, name):
    jp, tp, prompts = base
    over = dict(VARIANTS[name])
    jc, tc = smoke_pair(**over)
    if over.get("quant_bits"):
        jp = jbl.tree_prepare_serving(jp, jc.quant)
        tp = tbl.tree_prepare_serving(tp, tc.quant)
    return jc, jp, tc, tp, prompts


def _serve(tc, tp, prompts, news=NEWS, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefix_cache", False)
    eng = Engine(tc, tp, device="cpu", **kw)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_parity_with_jax_reference(base, variant):
    """Prompts below / at / across the 16-token chunk boundary admitted in
    waves through 2 slots: every stream equals the reference's, and after
    the run no slot holds a page."""
    jc, jp, tc, tp, prompts = _variant(base, variant)
    refs = [reference_greedy(jc, jp, p, n, MAX_SEQ)
            for p, n in zip(prompts, NEWS)]
    eng, reqs = _serve(tc, tp, prompts)
    for r, ref in zip(reqs, refs):
        assert r.done
        assert r.out_tokens == ref
    assert eng.pool.slot_refs_total == 0
    assert eng.pages_in_use == 0
    assert 0 < eng.pages_high_water <= eng.num_pages


@pytest.mark.parametrize("variant", ["fp", "int8_kv"])
def test_decode_steps_and_kernel_do_not_change_streams(base, variant):
    """decode_steps 1 vs 3 and decode_kernel on vs off: identical streams;
    fused steps mean fewer host syncs for the same tokens."""
    _, _, tc, tp, prompts = _variant(base, variant)
    runs = {}
    for ds, dk in ((1, False), (3, False), (1, True), (3, True)):
        eng, reqs = _serve(tc, tp, prompts, decode_steps=ds, decode_kernel=dk)
        runs[ds, dk] = ([r.out_tokens for r in reqs], eng.n_syncs,
                        eng.n_generated, eng.kv_bytes_read)
    streams = {k: v[0] for k, v in runs.items()}
    assert len({str(s) for s in streams.values()}) == 1
    assert runs[3, False][2] == runs[1, False][2]
    assert runs[3, False][1] < runs[1, False][1]
    # kernel reads track live tokens; the gather reads slots x max_seq rows
    assert runs[1, True][3] < runs[1, False][3]


def test_eos_at_admission_and_max_seq_clip(base):
    jp, tp, prompts = base
    _, tc = smoke_pair()
    first = _serve(tc, tp, prompts[:1], news=(4,))[1][0].out_tokens[0]
    eng, reqs = _serve(tc, tp, prompts[:1], news=(4,), stop_tokens=(first,))
    assert reqs[0].out_tokens == [first]
    assert reqs[0].result.finish_reason == "eos"
    assert eng.pages_in_use == 0
    eng, reqs = _serve(tc, tp, [prompts[4]], news=(50,), max_seq=48)
    r = reqs[0]
    assert r.clamped and r.result.finish_reason == "max_seq"
    # the budget clamps to max_seq - len(prompt): the last KV row written
    # is max_seq - 2, and the token it yields is the stream's last
    assert len(r.prompt) + len(r.out_tokens) == 48
    assert eng.pages_in_use == 0


@pytest.mark.parametrize("option", [
    {"disagg": True, "role": "prefill"}, {"disagg": True, "role": "decode"},
    {"mesh": "model=1", "draft_len": 2, "drafter": "model"}])
def test_unported_options_raise(base, option):
    """Speculation, disaggregation in this process and a mesh are served
    (tests/test_torch_speculate.py, tests/test_torch_disagg.py,
    tests/test_torch_parallel_engine.py); the multi-process roles of
    disaggregation and the model drafter under a mesh still raise."""
    _, tp, _ = base
    _, tc = smoke_pair()
    with pytest.raises(NotImplementedError):
        Engine(tc, tp, device="cpu", prefix_cache=False, **option)


def test_device_defaults_to_cuda_and_prefix_cache_warns(base):
    """No GPU and no explicit CPU request: a clear error, never a silent CPU
    run.  The default Engine is the reference's: the prefix cache is on
    and constructs without a warning."""
    import warnings
    _, tp, _ = base
    _, tc = smoke_pair()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            Engine(tc, tp, prefix_cache=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = Engine(tc, tp, device="cpu")
    assert eng.prefix is not None and eng.prefix_stats()["enabled"]
    assert EngineOptions().prefix.enabled
    assert SamplingConfig().method == "greedy"


@pytest.mark.parametrize("kw", [
    {}, {"num_slots": 3, "max_seq": 96, "decode_steps": 4, "eos_id": 7},
    {"sampling": "top_p", "top_p": 0.9, "temperature": 0.7},
    {"kv_layout": "paged", "num_pages": 12, "decode_kernel": True,
     "prefix_cache": False, "draft_len": 2}])
def test_engine_options_build_matches_jax(kw):
    """EngineOptions.build gives the reference's options field by field,
    and bad knobs fail with the reference's messages."""
    import dataclasses
    from repro.runtime.options import EngineOptions as JOpts
    assert dataclasses.asdict(EngineOptions.build(**kw)) == \
        dataclasses.asdict(JOpts.build(**kw))
    for bad in ({"num_slots": 0}, {"kv_layout": "ring"}, {"top_k": 0,
                                                          "sampling": "top_k"}):
        with pytest.raises((ValueError, TypeError)) as a:
            JOpts.build(**bad)
        with pytest.raises(type(a.value), match=str(a.value)[:20]):
            EngineOptions.build(**bad)


def test_filter_logits_matches_jax():
    """Temperature / rank-based top-k (exactly k survive ties) / top-p
    restriction equal the reference's on tied logits."""
    from repro.runtime import sampling as jsmp
    from repro_torch.runtime import sampling as tsmp
    logits = np.asarray([[3.0, 1.0, 3.0, 3.0, -2.0, 0.5],
                         [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]], np.float32)
    for sc in (dict(method="top_k", top_k=2, temperature=0.7),
               dict(method="top_p", top_p=0.6),
               dict(method="temperature", temperature=2.0)):
        a = jsmp._filter_logits(jax.numpy.asarray(logits),
                                jsmp.SamplingConfig(**sc))
        b = tsmp._filter_logits(torch.from_numpy(logits),
                                tsmp.SamplingConfig(**sc))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (tsmp.sample(torch.from_numpy(logits), tsmp.SamplingConfig())
            .tolist() == [0, 5])


def test_page_allocator_matches_jax_and_host_mirror():
    """admit_update (evict → share → grant → register; lowest free id
    first, slots ascending), apply_refs_delta and release give the
    reference's pool state, and HostPool replays the grants."""
    from repro.runtime import pages as jpg
    from repro_torch.runtime import pages as tpg
    S, mp, P = 3, 4, 10
    jpool, tpool = jpg.init_pool(S, mp, P), tpg.init_pool(S, mp, P)
    host = tpg.HostPool(P, S)

    def same():
        for f in ("refs", "tables", "n_pages", "owned"):
            np.testing.assert_array_equal(getattr(tpool, f).numpy(),
                                          np.asarray(getattr(jpool, f)))
        np.testing.assert_array_equal(tpool.refs.numpy(), host.refs)
        np.testing.assert_array_equal(tpg.free_mask(tpool).numpy(),
                                      host.refs == 0)

    def delta(d):
        a = np.zeros(P, np.int32)
        for p, v in d.items():
            a[p] = v
        return a

    # (admitting, fresh pages, {slot: shared ids}, evict, register, dead):
    # round 1 registers a cache ref on pages 0 and 1; round 3 is
    # eviction-only (page 1 freed); round 4 evicts page 0's cache ref and
    # shares it back in the same round, so page 0 must not be granted
    rounds = [([True, False, True], [2, 0, 3], {}, {}, {}, [True, False,
                                                            False]),
              ([False, True, False], [0, 4, 0], {}, {}, {}, [False, False,
                                                             True]),
              ([True, False, True], [2, 0, 1], {}, {}, {0: 1, 1: 1},
               [True, True, False]),
              (None, None, None, {1: -1}, None, None),
              ([True, False, False], [2, 0, 0], {0: [0]}, {0: -1}, {},
               [True, False, True])]
    for adm, new, sh, ev, rg, dead in rounds:
        if adm is None:
            jpool = jpg.apply_refs_delta(jpool, jax.numpy.asarray(delta(ev)))
            tpool = tpg.apply_refs_delta(tpool, torch.from_numpy(delta(ev)))
            host.apply_delta(ev)
            same()
            continue
        shared = np.zeros((S, mp), np.int32)
        n_shared = np.zeros(S, np.int32)
        for s_, ids in sh.items():
            shared[s_, :len(ids)] = ids
            n_shared[s_] = len(ids)
        args = (np.asarray(adm), shared, n_shared, np.asarray(new, np.int32),
                delta(ev), delta(rg))
        jpool = jpg.admit_update(jpool, *map(jax.numpy.asarray, args))
        tpool = tpg.admit_update(tpool, *map(torch.from_numpy, args))
        granted = host.admit_round(
            [(s_, sh.get(s_, []), n) for s_, (a, n) in enumerate(zip(adm,
                                                                     new))
             if a], ev, rg)
        same()
        for s_, ids in granted.items():
            assert tpool.tables[s_, :int(tpool.n_pages[s_])].tolist() == \
                sh.get(s_, []) + ids
        if sh:
            assert granted[0] == [1, 2]
        d = np.asarray(dead)
        jpool = jpg.release(jpool, jax.numpy.asarray(d))
        tpool = tpg.release(tpool, torch.from_numpy(d))
        for s_ in np.flatnonzero(d):
            host.release_slot(int(s_))
        same()
