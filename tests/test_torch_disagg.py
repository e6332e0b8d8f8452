"""Prefill/decode disaggregation in the port (`pages.export_pages` /
`import_pages` / `adopt`, `Scheduler.plan_transfers`, the workers'
`export_request` / `import_request`, `Engine(disagg=True)`) against the JAX
package's on the same numpy weights and prompts: tests/test_disagg.py case
by case.

Greedy streams of the port's disaggregated Engine equal its colocated
Engine's and the JAX colocated Engine's for every cache architecture the
port serves (gqa, mla, int8 KV) under staggered admissions, and its
transfer telemetry equals the JAX disaggregated Engine's.  Every engine
here runs with `check_invariants=True`, so each assertion also re-proves
I1–I6 on both HostPool mirrors after every transfer round and the I7
content check (the destination pages exported again, compared bit for bit
with the moved tiles).  The page transfer functions are bit-exact against
the JAX ones on random pools.  Also: decode-pool backpressure, abort
before transfer, the validation surface, the prefix cache and speculation
switched off, sampled streams that do not depend on the split (the
request's generator moves with it), and the launcher's `--role both`
report against the reference launcher's."""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.runtime import pages as jpg
from repro.runtime.serve import Engine as JEngine
from repro_torch.runtime import pages as tpg
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import np_, smoke_pair, to_torch
from test_torch_engine_features import _launch, _timing_free

jax.config.update("jax_platform_name", "cpu")

# every cache architecture the port serves, all pool-representable
ARCHS = {
    "gqa": ("granite-8b", {}),
    "mla": ("minicpm3-4b", {}),
    "int8kv": ("granite-8b", {"quant_kv": True}),
}


@functools.lru_cache(maxsize=None)
def _params(arch):
    jc, _ = smoke_pair(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jp, to_torch(jp)


def _setup(name):
    arch, over = ARCHS[name]
    jc, tc = smoke_pair(arch, **over)
    return (jc, tc) + _params(arch)


def _serve_staggered(engine_cls, cfg, params, prompts, news, **kw):
    """The first two requests admitted, two steps run, then the rest
    arrive mid-flight — transfers interleave with live decode and later
    admissions land while earlier requests still hold pages."""
    extra = {"device": "cpu"} if engine_cls is TEngine else {}
    with engine_cls(cfg, params, num_slots=2, max_seq=64, kv_layout="paged",
                    prefix_cache=False, check_invariants=True, **kw,
                    **extra) as eng:
        reqs = [eng.submit(p, n) for p, n in zip(prompts[:2], news[:2])]
        eng.step()
        eng.step()
        reqs += [eng.submit(p, n) for p, n in zip(prompts[2:], news[2:])]
        eng.run()
        assert all(r.done for r in reqs)
        # both pools drained: no slot holds a reference, no page retained
        assert eng.pages_in_use == 0
        assert eng.sched.pool.pages_in_use == 0
        return [r.out_tokens for r in reqs], eng.disagg_stats(), eng


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_disagg_greedy_parity_staggered(name):
    """Port disagg == port colocated == JAX colocated, stream for stream;
    the port's transfer telemetry equals the JAX disaggregated Engine's;
    the handoff ran and I1–I7 held after every transfer round."""
    jc, tc, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    lens = (3, 17, 29, 9, 40)
    news = (5, 7, 4, 6, 3)
    prompts = [rng.integers(0, tc.vocab_size, size=n) for n in lens]
    jcolo, _, _ = _serve_staggered(JEngine, jc, jp, prompts, news)
    _, jds, _ = _serve_staggered(JEngine, jc, jp, prompts, news, disagg=True)
    colo, cs, _ = _serve_staggered(TEngine, tc, tp, prompts, news)
    disagg, ds, eng = _serve_staggered(TEngine, tc, tp, prompts, news,
                                       disagg=True)
    assert colo == jcolo
    assert disagg == colo
    assert ds == jds
    assert not cs["enabled"] and ds["enabled"]
    assert ds["pages_transferred"] >= len(prompts)   # >= 1 page each
    assert ds["transfer_rounds"] >= 1
    assert 0 < ds["decode_pages_high_water"] <= ds["decode_pages"]
    assert 0 < ds["prefill_pages_high_water"] <= ds["prefill_pages"]
    assert eng.n_invariant_checks > ds["transfer_rounds"]
    # a prefill side sized apart from the decode side streams the same
    other, _, _ = _serve_staggered(TEngine, tc, tp, prompts, news,
                                   disagg=True, prefill_slots=3,
                                   prefill_pages=9)
    assert other == colo


def test_decode_pool_pressure_backpressures_transfer():
    """A decode pool too small for two in-flight requests: the second
    prefilled prompt waits in the ready queue (counted), then moves once
    the first one's pages free up; streams equal the colocated engine's,
    the counts equal the JAX engine's, and neither pool leaks."""
    jc, tc, jp, tp = _setup("gqa")
    rng = np.random.default_rng(1)
    # 40-token prompts + 10 new tokens -> 50 rows -> 4 pages each with the
    # 16-row page; a 5-page decode pool holds one request at a time
    prompts = [rng.integers(0, tc.vocab_size, size=40) for _ in range(3)]
    news = (10, 10, 10)
    kw = dict(num_slots=2, max_seq=64, kv_layout="paged",
              prefix_cache=False, check_invariants=True)
    stats = []
    for cls, cfg, params, extra in ((JEngine, jc, jp, {}),
                                    (TEngine, tc, tp, {"device": "cpu"})):
        with cls(cfg, params, num_pages=5, disagg=True, prefill_pages=8,
                 **kw, **extra) as eng:
            reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
            eng.run()
            assert all(r.done for r in reqs)
            st = eng.disagg_stats()
            assert st["transfers_backpressured"] > 0
            assert st["decode_pages_high_water"] <= 5
            assert eng.pages_in_use == 0             # decode pool drained
            assert eng.sched.pool.pages_in_use == 0  # prefill pool drained
            assert eng.pool.slot_refs_total == 0
            stats.append(st)
            streams = [r.out_tokens for r in reqs]
    assert stats[0] == stats[1]
    with TEngine(tc, tp, device="cpu", **kw) as eng:
        reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
        eng.run()
        assert streams == [r.out_tokens for r in reqs]


def test_abort_before_transfer_releases_prefill_pages():
    """Aborting a request that finished prefill but has not moved to the
    decode pool releases its prefill pages and reports "aborted"."""
    _, tc, _, tp = _setup("gqa")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tc.vocab_size, size=40) for _ in range(2)]
    with TEngine(tc, tp, num_slots=1, max_seq=64, kv_layout="paged",
                 num_pages=4, prefill_pages=8, prefill_slots=2, disagg=True,
                 prefix_cache=False, check_invariants=True,
                 device="cpu") as eng:
        r0 = eng.submit(prompts[0], 10)
        r1 = eng.submit(prompts[1], 10)
        # one step: both prompts prefill (2 prefill slots) but only r0
        # fits the single decode slot; r1 waits in the ready queue
        eng.step()
        assert eng.sched.ready and eng.sched.ready[0].uid == r1.uid
        assert eng.sched.pool.pages_in_use == 4
        assert eng.abort(r1)
        assert not eng.sched.ready
        assert eng.sched.pool.pages_in_use == 0
        assert eng.p_state.gens == (None, None)
        eng.run()
        assert r0.done and r1.done
        assert r1.result.finish_reason == "aborted"
        assert r1.out_tokens and len(r0.out_tokens) == 10
        assert eng.pages_in_use == 0
        assert eng.sched.pool.pages_in_use == 0
        assert not eng.abort(r1)


def test_disagg_validation_surface():
    """The reference's order and exception types: role, layout, mesh, page
    representation (jamba's recurrent state has no page to move)."""
    _, tc, _, tp = _setup("gqa")
    kw = dict(num_slots=2, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        TEngine(tc, tp, kv_layout="dense", disagg=True, **kw)
    for role in ("prefill", "decode"):
        with pytest.raises(NotImplementedError, match="multi-process"):
            TEngine(tc, tp, kv_layout="paged", disagg=True, role=role, **kw)
        with pytest.raises(NotImplementedError, match="multi-process"):
            TEngine(tc, tp, kv_layout="dense", disagg=True, role=role, **kw)
    with pytest.raises(ValueError, match="mesh"):
        TEngine(tc, tp, kv_layout="paged", disagg=True, mesh="model=1", **kw)
    # without disaggregation the mesh is served (colocated)
    with TEngine(tc, tp, kv_layout="paged", mesh="model=1", **kw) as eng:
        assert eng.mesh.shape == {"data": 1, "model": 1}
    _, rcfg = smoke_pair("jamba-1.5-large-398b")
    with pytest.raises(ValueError, match="page representation"):
        TEngine(rcfg, {}, kv_layout="paged", disagg=True, **kw)


def test_disagg_disables_prefix_and_speculation():
    """The prefix cache and speculation switch off under disaggregation;
    the decode kernels stay selectable (the gather here, on the CPU)."""
    _, tc, _, tp = _setup("gqa")
    for drafter in ("ngram", "model"):
        with TEngine(tc, tp, num_slots=2, max_seq=64, kv_layout="paged",
                     disagg=True, draft_len=3, drafter=drafter,
                     decode_kernel=True, device="cpu") as eng:
            assert eng.prefix is None and eng.draft_len == 0
            assert eng.drafter is None and eng.decode_kernel
            assert not eng.spec_stats()["enabled"]
            assert not eng.prefix_stats()["enabled"]
            r = eng.submit(np.arange(1, 9), 5)
            eng.run()
            assert r.done and len(r.out_tokens) == 5


def _random_pool(rng, n_periods, P, ps):
    """A two-position cache tree of pool leaves: fp K/V and int8 K/V with
    f32 row scales, as numpy."""
    return {"pos0": {"k": rng.normal(size=(n_periods, P, ps, 2, 8))
                     .astype(np.float32),
                     "v": rng.normal(size=(n_periods, P, ps, 2, 8))
                     .astype(np.float32)},
            "pos1": {"k": rng.integers(-127, 128, (n_periods, P, ps, 2, 8))
                     .astype(np.int8),
                     "ks": rng.random((n_periods, P, ps, 2))
                     .astype(np.float32)}}


def _flags(tree):
    return jax.tree_util.tree_map(lambda _: True, tree)


@pytest.mark.parametrize("seed", range(3))
def test_export_import_adopt_bit_exact_against_jax(seed):
    """`export_pages` gathers the same tiles as the JAX function (clipped
    ids included); `import_pages` of the first n tiles writes the same
    pool as the JAX one with live = arange < n (n below the table length
    included), and `adopt` gives the same allocator state."""
    rng = np.random.default_rng(seed)
    P, ps, mp, S = 12, 4, 5, 3
    src_np = _random_pool(rng, 2, P, ps)
    dst_np = _random_pool(rng, 2, P, ps)
    flags = _flags(src_np)
    src_ids = rng.permutation(P)[:mp].astype(np.int32)
    src_ids[-1] = P + 3                                    # clipped
    jtiles = jpg.export_pages(jax.tree_util.tree_map(jnp.asarray, src_np),
                              flags, jnp.asarray(src_ids))
    ttiles = tpg.export_pages(to_torch(src_np), flags,
                              torch.from_numpy(src_ids))
    for key in ("pos0", "pos1"):
        for leaf in ttiles[key]:
            np.testing.assert_array_equal(np_(ttiles[key][leaf]),
                                          np.asarray(jtiles[key][leaf]))
    for n in (mp, 2, 0):
        dst_ids = rng.permutation(P)[:mp].astype(np.int32)
        live = np.arange(mp) < n
        jout = jpg.import_pages(jax.tree_util.tree_map(jnp.asarray, dst_np),
                                flags, jtiles, jnp.asarray(dst_ids),
                                jnp.asarray(live))
        tout = tpg.import_pages(to_torch(dst_np), flags, ttiles,
                                torch.from_numpy(dst_ids), n)
        for key in ("pos0", "pos1"):
            for leaf in tout[key]:
                np.testing.assert_array_equal(np_(tout[key][leaf]),
                                              np.asarray(jout[key][leaf]))
        refs = rng.integers(0, 3, P).astype(np.int32)
        tables = rng.integers(0, P, (S, mp)).astype(np.int32)
        n_pages = rng.integers(0, mp + 1, S).astype(np.int32)
        owned = rng.random((S, mp)) < 0.5
        slot = int(rng.integers(0, S))
        jpool = jpg.adopt(jpg.PagePool(*map(jnp.asarray, (refs, tables,
                                                           n_pages, owned))),
                          slot, jnp.asarray(dst_ids), n)
        tpool = tpg.adopt(tpg.PagePool(*map(torch.from_numpy,
                                            (refs, tables, n_pages, owned))),
                          slot, torch.from_numpy(dst_ids), n)
        for a, b in zip(tpool, jpool):
            np.testing.assert_array_equal(np_(a), np.asarray(b))


def test_sampled_streams_do_not_depend_on_the_split():
    """top-p streams, disaggregated == colocated: each request's generator
    is made at its prefill and moves with it to the decode slot, so its
    stream depends on the seeds only."""
    _, tc, _, tp = _setup("gqa")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, size=int(n))
               for n in (5, 21, 33, 12, 40)]
    news = (9, 6, 8, 7, 5)
    kw = dict(sampling="top_p", top_p=0.9, temperature=0.8, seed=3)
    colo, _, _ = _serve_staggered(TEngine, tc, tp, prompts, news, **kw)
    disagg, ds, _ = _serve_staggered(TEngine, tc, tp, prompts, news,
                                     disagg=True, prefill_slots=3, **kw)
    assert disagg == colo and ds["pages_transferred"] > 0
    greedy, _, _ = _serve_staggered(TEngine, tc, tp, prompts, news)
    assert greedy != colo


def test_launcher_role_both_reports_as_the_reference(monkeypatch, capsys):
    """`--role both` through the port's launcher (CPU subprocess) against
    the reference launcher's `main`: the same lines apart from wall-time
    readings and the port's `device=` note; the disagg line, a host
    decision, equal to the digit."""
    from repro.launch import serve as jlaunch
    args = ["--role", "both", "--prefill-slots", "2", "--prefill-pages",
            "12", "--check-invariants"]
    port = _launch("repro_torch.launch.serve", ["--device", "cpu"] + args)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "granite-8b",
                                      "--smoke"] + args)
    jlaunch.main()
    ref = capsys.readouterr().out.strip().splitlines()
    assert port[0].endswith(", device=cpu)")
    port[0] = port[0].replace(", device=cpu)", ")")
    assert _timing_free(port) == _timing_free(ref)
    line = [x for x in port if x.startswith("  disagg:")]
    assert len(line) == 1 and "over 2 slots" in line[0]
    assert port[0].startswith("8/8 requests done")
