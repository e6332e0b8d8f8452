"""The port's Engine surface beyond greedy paged serving, against the JAX
package's on the same inputs: `abort` of queued and running requests,
completion order and the RequestResult counters (ports of
tests/test_engine_options.py's cases); `check_invariants` passing on live
engines and raising on a mirror corrupted on purpose; the device
allocator (`admit_update` with share / evict / register deltas,
`apply_refs_delta`, `release`, `cow_copy`) against the JAX functions on
random schedules; and the launcher's new flags, whose report lines must
read as the reference launcher's."""
import os
import re
import subprocess
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
from test_torch_convert import REPO, smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def base():
    jc, tc = smoke_pair()
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, to_torch(jp)


def _both(base, script, **kw):
    """script(engine) on the JAX Engine, then on the port's."""
    jc, jp, tc, tp = base
    return (script(JEngine(jc, jp, **kw)),
            script(TEngine(tc, tp, device="cpu", **kw)))


def _res(results):
    return [(r.uid, r.tokens, r.finish_reason, r.prefill_tokens,
             r.pages_shared) for r in results]


def test_abort_queued_and_running(base):
    prompt = [3, 1, 4, 1, 5, 9]

    def script(eng):
        run_req = eng.submit(prompt, 30)
        queued = eng.submit(prompt, 30)
        assert eng.abort(queued)
        assert queued.done and queued.result.finish_reason == "aborted"
        assert queued.result.tokens == ()
        eng.step()
        held = eng.pages_in_use
        assert eng.abort(run_req)
        assert run_req.result.finish_reason == "aborted"
        assert len(run_req.result.tokens) >= 1
        after = eng.pages_in_use
        assert after < held
        assert not eng.abort(run_req)          # already finished
        nxt = eng.submit(prompt, 4)
        results = eng.run()
        assert [r.uid for r in results] == [queued.uid, run_req.uid, nxt.uid]
        assert nxt.result.finish_reason == "budget"
        return held, after, _res(results), eng.pool.refs.tolist()

    j, t = _both(base, script, num_slots=1, max_seq=64,
                 check_invariants=True)
    assert t == j


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_abort_frees_slot_for_the_queue(base, kv_layout):
    """Aborting a running request mid-decode lets the queued one admit in
    the next round; the other streams are untouched."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=n) for n in (12, 20, 7)]

    def script(eng):
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.step()
        eng.step()
        assert eng.abort(reqs[0])
        results = eng.run()
        return _res(results), eng.n_syncs

    j, t = _both(base, script, num_slots=2, max_seq=64, kv_layout=kv_layout,
                 check_invariants=True)
    assert t == j
    assert [r[2] for r in t[0]] == ["aborted", "budget", "budget"]


def test_run_returns_results_in_completion_order(base):
    def script(eng):
        short = eng.submit([1, 2, 3], 3)
        long = eng.submit([4, 5, 6], 12)
        results = eng.run()
        assert [r.uid for r in results] == [short.uid, long.uid]
        assert eng.run() == []
        assert short.result is results[0]
        return _res(results)

    j, t = _both(base, script, num_slots=2, max_seq=48)
    assert t == j


def test_result_counters_prefill_and_pages_shared(base):
    """prefill_tokens counts the prompt rows whose compute ran (a warm
    admission skips the shared pages); pages_shared counts the read-only
    mappings."""
    rng = np.random.default_rng(0)
    sys_p = list(rng.integers(1, 256, 32))

    def script(eng):
        cold = eng.submit(sys_p + [1, 2, 3], 4)
        eng.run()
        warm = eng.submit(sys_p + [7, 8, 9], 4)
        eng.run()
        assert (cold.result.prefill_tokens, cold.result.pages_shared) == \
            (35, 0)
        assert (warm.result.prefill_tokens, warm.result.pages_shared) == \
            (3, 2)
        return _res([cold.result, warm.result])

    j, t = _both(base, script, num_slots=2, max_seq=96, prefix_cache=True,
                 check_invariants=True)
    assert t == j


def _corrupt(eng, how):
    if how == "mirror_refs":
        eng.pool.refs[eng.pool.slot_tables[0][0]] += 1
    elif how == "mirror_table":
        eng.pool.slot_tables[0][0] += 1
    elif how == "mirror_owned":
        eng.pool.slot_owned[0][0] = not eng.pool.slot_owned[0][0]
    elif how == "device_refs":
        eng.state.pages.refs[-1] += 1
    elif how == "cached_count":
        eng.prefix.page_chains[10_000] = 1


@pytest.mark.parametrize("how", ["mirror_refs", "mirror_table",
                                 "mirror_owned", "device_refs",
                                 "cached_count"])
def test_invariant_check_raises_on_corruption(base, how):
    """A live engine passes its checks after every sync; one corrupted
    entry of the mirror, the device pool or the cache count fails the next
    check with AssertionError."""
    _, _, tc, tp = base
    eng = TEngine(tc, tp, num_slots=2, max_seq=64, check_invariants=True,
                  device="cpu")
    eng.submit(list(range(1, 40)), 10)
    eng.submit(list(range(50, 70)), 10)
    eng.step()
    eng.step()
    assert eng.n_invariant_checks >= 2
    eng._verify_invariants()
    _corrupt(eng, how)
    with pytest.raises(AssertionError):
        eng._verify_invariants()


def _tensors(arrays, to_jax):
    return [jnp.asarray(a) if to_jax else torch.from_numpy(a)
            for a in arrays]


def _same_pool(tpool, jpool):
    for f in ("refs", "tables", "n_pages", "owned"):
        np.testing.assert_array_equal(getattr(tpool, f).numpy(),
                                      np.asarray(getattr(jpool, f)), f)


@pytest.mark.parametrize("seed", range(4))
def test_device_pool_matches_jax_on_random_schedules(seed):
    """Random rounds of admit_update with shares of cached pages, eviction
    and registration deltas, eviction-only rounds (apply_refs_delta) and
    releases: the port's device pool equals the JAX functions' and the
    HostPool mirror's after every round."""
    rng = np.random.default_rng(seed)
    S, mp, P = 3, 4, 12
    jpool, tpool = jpg.init_pool(S, mp, P), tpg.init_pool(S, mp, P)
    host = tpg.HostPool(P, S)
    occupied = [False] * S
    cached: set[int] = set()
    for _ in range(14):
        op = rng.integers(3)
        ev = np.zeros(P, np.int32)
        rg = np.zeros(P, np.int32)
        evict = {p: -1 for p in sorted(cached) if rng.integers(3) == 0}
        for p in evict:
            ev[p] = -1
            cached.discard(p)
        if op == 0:
            admitting = np.zeros(S, bool)
            shared = np.zeros((S, mp), np.int32)
            n_shared = np.zeros(S, np.int32)
            new_pages = np.zeros(S, np.int32)
            grants = []
            free_cnt = int((host.refs == 0).sum()) - sum(
                1 for p in evict if host.refs[p] == 1)
            for s in range(S):
                if occupied[s] or rng.integers(2):
                    continue
                sh = [int(p) for p in rng.permutation(sorted(cached))][
                    :int(rng.integers(0, min(len(cached), mp - 1) + 1))]
                fresh = int(rng.integers(1, mp - len(sh) + 1))
                if fresh > free_cnt:
                    break
                free_cnt -= fresh
                admitting[s], n_shared[s], new_pages[s] = True, len(sh), fresh
                shared[s, :len(sh)] = sh
                occupied[s] = True
                grants.append((s, sh, fresh))
            granted = host.admit_round(grants, evict)
            # register the first fresh page of each admitted slot
            reg = {}
            for s, ids in granted.items():
                if ids and ids[0] not in cached:
                    reg[ids[0]] = 1
                    cached.add(ids[0])
            host.apply_register(reg)
            for p, d in reg.items():
                rg[p] = d
            args = (admitting, shared, n_shared, new_pages, ev, rg)
            jpool = jpg.admit_update(jpool, *_tensors(args, True))
            tpool = tpg.admit_update(tpool, *_tensors(args, False))
        elif op == 1:
            host.apply_delta(evict)
            jpool = jpg.apply_refs_delta(jpool, jnp.asarray(ev))
            tpool = tpg.apply_refs_delta(tpool, torch.from_numpy(ev))
        else:
            host.apply_delta(evict)
            jpool = jpg.apply_refs_delta(jpool, jnp.asarray(ev))
            tpool = tpg.apply_refs_delta(tpool, torch.from_numpy(ev))
            dead = np.array([occupied[s] and bool(rng.integers(2))
                             for s in range(S)])
            for s in np.flatnonzero(dead):
                host.release_slot(int(s))
                occupied[s] = False
            jpool = jpg.release(jpool, jnp.asarray(dead))
            tpool = tpg.release(tpool, torch.from_numpy(dead))
        _same_pool(tpool, jpool)
        np.testing.assert_array_equal(tpool.refs.numpy(), host.refs)
        assert int(tpool.n_pages.sum()) == int(tpool.refs.sum()) - len(cached)


@pytest.mark.parametrize("case", ["some", "none", "chained"])
def test_cow_copy_matches_jax(case):
    """cow_copy copies whole pages into every pool leaf exactly as the JAX
    function does; entries with src < 0 copy nothing; a source that is
    also another entry's target yields its rows from before the call."""
    rng = np.random.default_rng(7)
    P = 8
    src = {"some": [3, -1, 5, -1], "none": [-1, -1, -1, -1],
           "chained": [2, 4, -1, 6]}[case]
    dst = {"some": [0, 6, 1, 7], "none": [0, 1, 2, 3],
           "chained": [4, 5, 3, 2]}[case]
    leaves = {"k": rng.normal(size=(2, P, 4, 2, 3)).astype(np.float32),
              "ks": rng.normal(size=(2, P, 4, 2)).astype(np.float32),
              "v": rng.integers(-127, 128, (2, P, 4, 2, 3)).astype(np.int8)}
    caches = {"pos0": {k: v.copy() for k, v in leaves.items()}}
    flags = {"pos0": {k: True for k in leaves}}
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    want = jpg.cow_copy(jax.tree_util.tree_map(jnp.asarray, caches), flags,
                        jnp.asarray(s), jnp.asarray(d))
    got = {"pos0": {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}}
    tpg.cow_copy(got, flags, torch.from_numpy(s), torch.from_numpy(d))
    for k in leaves:
        np.testing.assert_array_equal(got["pos0"][k].numpy(),
                                      np.asarray(want["pos0"][k]), k)


def _launch(mod, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", mod, "--arch", "granite-8b",
                          "--smoke"] + args, env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def _timing_free(lines):
    """Report lines with the wall-time readings masked."""
    out = [re.sub(r"tokens in [\d.]+s \([\d.]+ tok/s", "tokens in T", lines[0]),
           re.sub(r"mean ttft \d+ms", "mean ttft T", lines[1])]
    return out + lines[2:]


@pytest.mark.parametrize("args", [
    ["--sampling", "top_p", "--top-p", "0.9", "--shared-prefix", "32",
     "--check-invariants"],
    ["--kv-layout", "dense"]], ids=["top_p_prefix", "dense"])
def test_launcher_flags_report_as_the_reference(args, monkeypatch, capsys):
    """The port's launcher in a CPU subprocess against the reference
    launcher's `main` in process: the same lines, word for word, apart from
    the wall-time readings and the port's `device=` note; the kv pool and
    prefix-cache lines (host decisions) equal to the digit."""
    port = _launch("repro_torch.launch.serve", ["--device", "cpu"] + args)
    from repro.launch import serve as jlaunch
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "granite-8b",
                                      "--smoke"] + args)
    jlaunch.main()
    ref = capsys.readouterr().out.strip().splitlines()
    assert port[0].endswith(", device=cpu)")
    port[0] = port[0].replace(", device=cpu)", ")")
    assert _timing_free(port) == _timing_free(ref)
    assert port[0].startswith("8/8 requests done")
    if "dense" in args:
        assert port[-1].startswith("  kv dense: 4 slots x 128 rows")
    else:
        assert "sampling=top_p" in port[0]
        assert port[-1].startswith("  prefix cache: 4/8 hits")
