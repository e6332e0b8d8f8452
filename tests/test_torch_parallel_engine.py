"""The port's mesh Engine (`Engine(mesh=...)`: tensor-parallel attention
and dense FF, expert-parallel MoE) and `launch/serve.py --shard`.

The reference's own mesh Engine test fails under jax 0.9.0 (a
ShardingTypeError in `layers.embed` on the vocab-sharded embedding), so
the port's mesh Engine is held against the reference's meshless Engine —
the sharded Engine only partitions that function — and against the
port's own meshless Engine, on the same weights and submissions.  The
mesh Engines run on 4 gloo ranks on the CPU, spawned once for the file
(`_torch_parallel_ranks.engine_rank`): granite-8b smoke at 8 bits with
`mesh="model=2"` (the 4 ranks make it data=2 x model=2: each data rank
runs one of the 2 slots on a 2-way TP engine), fp KV through the gather
oracle and int8 KV through
the int8 decode kernel's wrapper; qwen3-moe-30b-a3b smoke at 8 bits with
`mesh="data=2,model=2"` through the EP route and the fp decode kernel's
wrapper, and its per_source dispatch at no-drop capacity (where it is the
dense dispatch's result).  On the CPU the kernel wrappers run their plain
versions, each rank over its own KV heads.  Greedy streams are equal on
every rank and to the port's meshless Engine's with the same options,
and for granite at fp KV to the reference's meshless Engine's too (the
port's meshless streams are held to the reference's for the other cases
in tests/test_torch_serve.py and tests/test_torch_moe.py; qwen3-moe's
weights are the port's own draw, so no JAX model is built for them).
Refusals: `close()` releases the sharding ctx (also after a construction
that raises) and non-dividing head counts raise ValueError.

The slot split over `data` (SPLIT, on "data=2,model=2" and on "data=4"
over the same 4 ranks): every layer kind and feature the mesh Engine
serves, each rank running its block of the 4 slots, against the
reference's meshless Engine on the same 8-bit weights (the port's draw,
carried into the reference bit for bit) — streams, every RequestResult
field but the time, the prefix-cache and speculation telemetry and the
host's counters — and against the port's meshless Engine in all of
these and the MoE drops.  Sampled streams come from torch generators,
not JAX's threefry (tests/test_torch_sampling.py holds the
distributions), so the top_k case is held to the port's meshless Engine
only.  On every rank the forwards ran S/n rows (3 slots do not split
two ways: every rank keeps all 3), `check_invariants=True` held, and
the data ranks' page pools are bit-equal.  The MLA,
mamba and xLSTM layer kinds and the model drafter, which the mesh Engine
refused until it took them, build and close on a one-rank mesh here;
their streams on model=2 are tests/test_torch_parallel_mixers.py's."""
import re

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import (engine_rank, engine_snapshot,
                                   serve_streams, split_serve, watched)
from repro.core import bramac_linear as jbl
from repro.models import model as JM
from repro.runtime.serve import Engine as JEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.serve import Engine as TEngine
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

NO_DROP = 4.0                            # qwen3-moe smoke: E / k = 8 / 2
MAX_SEQ = 32                             # serve_streams' default


def _waves(vocab, seed):
    """Two waves of two requests (prompts across the 16-token chunk)."""
    rng = np.random.default_rng(seed)
    return [[(list(rng.integers(1, vocab, 5)), 7),
             (list(rng.integers(1, vocab, 19)), 6)],
            [(list(rng.integers(1, vocab, 13)), 8),
             (list(rng.integers(1, vocab, 3)), 5)]]


# name: (arch, cfg overrides, Engine kwargs (mesh and options))
RUNS = {
    "granite": ("granite-8b", {}, {"mesh": "model=2"}),
    "granite_int8kv": ("granite-8b", {"quant_kv": True},
                       {"mesh": "model=2", "prefix_cache": False,
                        "decode_kernel": True}),
    "qwen3": ("qwen3-moe-30b-a3b", {},
              {"mesh": "data=2,model=2", "prefix_cache": False,
               "decode_kernel": True}),
    "qwen3_per_source": ("qwen3-moe-30b-a3b", {},
                         {"mesh": "data=2,model=2", "prefix_cache": False,
                          "dispatch": "per_source",
                          "capacity_factor": NO_DROP}),
}
# the slot split over `data`.  name: (arch, cfg overrides, Engine kwargs,
# meshes, traffic); every run has 4 slots unless it says otherwise.  The
# features share runs where they do not exclude each other: the n-gram
# drafter rides on the bf16 prefix run, the dense layout on the model
# drafter's (whose private draft cache is dense in either layout)
BOTH = ("data=2,model=2", "data=4")
XL_SPLIT = {"slstm_proj_factor": 1.5}    # sLSTM width 96: splits two ways
SPLIT = {
    "gqa_prefix_ngram": ("granite-8b", {}, {"prefix_chunk": 8,
                                            "draft_len": 3}, BOTH, "shared"),
    "gqa_int8": ("granite-8b", {"quant_kv": True},
                 {"prefix_chunk": 8, "decode_kernel": True}, BOTH, "shared"),
    "dense_model_drafter": ("granite-8b", {}, {
        "kv_layout": "dense", "draft_len": 3, "drafter": "model",
        "draft_bits": 2}, ("data=2,model=2",), "short"),
    "top_k": ("granite-8b", {}, {"sampling": "top_k", "top_k": 5,
                                 "temperature": 1.3, "prefix_chunk": 8},
              BOTH, "shared"),
    "slots3": ("granite-8b", {}, {"num_slots": 3, "prefix_chunk": 8},
               ("data=2,model=2",), "shared"),
    "mla": ("minicpm3-4b", {}, {"prefix_chunk": 8}, BOTH, "shared"),
    "moe_global": ("qwen3-moe-30b-a3b", {}, {"prefix_cache": False}, BOTH,
                   "shared"),
    "moe_per_source": ("qwen3-moe-30b-a3b", {},
                       {"prefix_cache": False, "dispatch": "per_source",
                        "capacity_factor": NO_DROP}, ("data=2,model=2",),
                       "shared"),
    "xlstm": ("xlstm-1.3b", XL_SPLIT, {}, BOTH, "short"),
    "jamba": ("jamba-1.5-large-398b", {}, {"prefix_cache": False},
              ("data=2,model=2",), "short"),
}
SPLIT_SEQ = 64
# sampled streams: held to the port's meshless Engine only (see above)
SAMPLED = ("top_k",)


def _split_waves(vocab, kind):
    """"shared": a wave of four requests, one behind a 28-token stem
    (1.75 pages), then a wave of three, two of them warm: at prefix_chunk
    8 their match of 24 tokens ends mid-page, so each admission splits a
    page by copy-on-write.  "short": short prompts, for the recurrent
    archs' one-token prefill (and the model drafter's slow reference)."""
    rng = np.random.default_rng(28)

    def tok(n):
        return list(rng.integers(1, vocab, n))
    if kind == "short":
        return [[(tok(4), 4), (tok(3), 5), (tok(5), 3), (tok(2), 4)],
                [(tok(3), 4), (tok(4), 3)]]
    stem = tok(28)
    return [[(stem + tok(5), 6), (tok(19), 7), (tok(9), 5), (tok(3), 8)],
            [(stem + tok(3), 7), (stem[:26] + tok(11), 5), (tok(13), 6)]]


def to_jax(tree):
    """The port's serving tree as the reference's (bit for bit): the
    inverse of `to_torch`, so the reference runs on the port's own draw."""
    from repro.core.quant import QuantizedTensor as JQT
    from repro_torch.core.quant import QuantizedTensor as TQT

    def arr(t):
        # a numpy copy the JAX array owns: the spawn moves the port tree's
        # storage into shared memory, freeing the buffer `numpy()` views
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return jax.numpy.asarray(np.array(t.view(torch.int16).numpy())
                                     ).view(jax.numpy.bfloat16)
        return jax.numpy.asarray(np.array(t.numpy()))

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, TQT):
            return JQT(arr(x.values), arr(x.scale), x.bits, x.packed,
                       tuple(x.shape), x.packed_axis)
        return arr(x)
    return walk(tree)


@pytest.fixture(scope="module")
def split_cases():
    """name -> (JAX cfg, JAX 8-bit tree, port cfg, port tree, waves,
    kwargs, meshes): one port draw per (arch, overrides), carried into
    the reference bit for bit."""
    trees, out = {}, {}
    for name, (arch, over, kw, meshes, kind) in SPLIT.items():
        jc, tc = smoke_pair(arch, quant_bits=8, **over)
        key = (arch, tuple(sorted(over.items())))
        if key not in trees:
            tq = TM.init_params(tc, torch.Generator().manual_seed(len(trees)),
                                "cpu", serving=tc.quant)
            trees[key] = (to_jax(tq), tq)
        kw = {"num_slots": 4, "max_seq": SPLIT_SEQ, **kw}
        out[name] = (jc, trees[key][0], tc, trees[key][1],
                     _split_waves(tc.vocab_size, kind), kw, meshes)
    return out


# the run also held to the reference's meshless Engine; the others vary
# the arch or a knob whose meshless streams the port already holds to the
# reference's (qwen3-moe: tests/test_torch_moe.py; int8 KV and the decode
# kernel: tests/test_torch_serve.py)
WITH_JAX = ("granite",)


@pytest.fixture(scope="module")
def cases():
    """name → (JAX cfg, JAX tree or None, port cfg, port tree, waves,
    kwargs).  One weight tree per arch: the JAX draw converted where a
    run is held to the reference, else the port's own draw."""
    trees, out = {}, {}
    for i, (name, (arch, over, kw)) in enumerate(RUNS.items()):
        jc, tc = smoke_pair(arch, quant_bits=8, **over)
        if arch not in trees:
            if any(RUNS[n][0] == arch for n in WITH_JAX):
                # one jitted draw: a fifth of the eager one's time
                jq = jax.jit(lambda key: jbl.tree_prepare_serving(
                    JM.init_params(jc, key), jc.quant))(jax.random.PRNGKey(0))
                trees[arch] = (jq, to_torch(jq))
            else:
                trees[arch] = (None, TM.init_params(
                    tc, torch.Generator().manual_seed(0), "cpu",
                    serving=tc.quant))
        jq, tq = trees[arch]
        out[name] = (jc, jq, tc, tq, _waves(tc.vocab_size, i), kw)
    return out


@pytest.fixture(scope="module")
def all_ranks(cases, split_cases):
    runs = {name: (tc, tq, waves, kw)
            for name, (_, _, tc, tq, waves, kw) in cases.items()}
    split = {f"{name}@{spec}": (tc, tq, waves, kw, spec)
             for name, (_, _, tc, tq, waves, kw, meshes)
             in split_cases.items() for spec in meshes}
    outs = comm.spawn(engine_rank, 4, runs, split, device="cpu")
    for other in outs[1:]:
        for name in RUNS:
            assert other[name] == outs[0][name], name
    return outs


@pytest.fixture(scope="module")
def ranks(all_ranks):
    return all_ranks[0]


def _jax_streams(jc, jq, waves, kw):
    kw = {k: v for k, v in kw.items() if k != "mesh"}
    eng = JEngine(jc, jq, num_slots=2, max_seq=MAX_SEQ, **kw)
    outs = []
    for wave in waves:
        reqs = [eng.submit(p, n) for p, n in wave]
        eng.run()
        outs += [list(r.out_tokens) for r in reqs]
    eng.close()
    return outs


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_engine_streams_equal_meshless(ranks, cases, name):
    """The mesh Engine's greedy streams (every rank the same) equal the
    port's meshless Engine's and, for WITH_JAX, the reference's meshless
    Engine's; the ctx is released when the Engine closes."""
    jc, jq, tc, tq, waves, kw = cases[name]
    got = ranks[name]
    assert all(len(s) == n for s, (_, n) in zip(
        got, [r for w in waves for r in w]))
    if name in WITH_JAX:
        assert got == _jax_streams(jc, jq, waves, kw)
    meshless = {k: v for k, v in kw.items() if k != "mesh"}
    assert got == serve_streams(tc, tq, waves, "cpu", **meshless)
    assert not ranks[name + "_ctx_after"]


def test_mesh_engine_shards_heads_and_releases_ctx(ranks):
    """Under model=2 a rank runs 2 of granite smoke's 4 query heads, 1 of
    its 2 KV heads and 56 of its 112 d_ff; decode_kernel=True is honoured;
    close() (twice) releases the ctx; 4-way TP of 2 KV heads raises
    ValueError and leaves no ctx behind."""
    assert ranks["heads"] == (2, 1, 56)
    assert ranks["decode_kernel"] is True
    assert ranks["ctx_open"] and ranks["ctx_closed"]
    assert "num_kv_heads=2" in ranks["heads_error"]
    assert ranks["ctx_after_error"]


@pytest.mark.parametrize("arch,kind", [
    ("minicpm3-4b", "mla"), ("xlstm-1.3b", "mlstm"),
    ("jamba-1.5-large-398b", "mamba")])
def test_mesh_refuses_unported_layer_kinds(arch, kind):
    """The layer kinds the mesh Engine refused until it served them (mla,
    mlstm and slstm, mamba) build under a mesh, hold the ctx while open,
    serve a request, and leave no sharding ctx after close()."""
    _, tc = smoke_pair(arch)
    assert any(s.startswith(kind + "+") for s in tc.layer_pattern)
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with TEngine(tc, params, num_slots=1, max_seq=16, mesh="model=1",
                 device="cpu") as eng:
        assert shd.active() is not None and eng.mesh.shape["model"] == 1
        req = eng.submit([1, 2, 3], 2)
        eng.run()
        assert req.done and len(req.out_tokens) == 2
    assert shd.active() is None


def test_mesh_refuses_model_drafter():
    """The model drafter, refused under a mesh until it was ported, builds
    under one: a 2-bit draft of the serving tree that drafts, and no ctx
    is left after close()."""
    _, tc = smoke_pair()
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with TEngine(tc, params, num_slots=1, max_seq=16, mesh="model=1",
                 draft_len=2, drafter="model", device="cpu") as eng:
        assert eng.drafter_kind == "model"
        assert eng.drafter.cfg.quant.bits_w == 2
        req = eng.submit([1, 2, 3], 4)
        eng.run()
        assert req.done and eng.spec_stats()["drafted"] > 0
    assert shd.active() is None


def _report(out):
    """A launcher report without its wall-clock readings and mesh
    naming: what a meshless run must reproduce."""
    out = re.sub(r"in \d+\.\ds \(\d+\.\d tok/s", "in T", out)
    out = re.sub(r"mean ttft \d+ms", "mean ttft T", out)
    return [ln for ln in re.sub(r", mesh=\{[^}]*\}", "", out)
            .strip().splitlines() if not ln.startswith("  mesh ")]


def test_launcher_shard_on_the_cpu(capfd):
    """`--shard 2` spawns 2 ranks; rank 0 prints the reference's report
    lines, naming the mesh (the ranks write to this process's stdout).
    `--shard data=2` splits the 4 slots over its 2 ranks (2 a rank), and
    rank 0's report equals the meshless launcher's but for its times."""
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--quant-bits", "8", "--requests", "3", "--new-tokens", "4"]
    tlaunch.main(args + ["--shard", "2"])
    out = capfd.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("3/3 requests done, 12 tokens in ")
    assert "mesh={'data': 1, 'model': 2})" in lines[0]
    assert "decode_kernel=off" in out
    assert lines[-1] == ("  mesh {'data': 1, 'model': 2}: each rank's "
                         "forwards run 4 of the 4 slots")
    tlaunch.main(args + ["--shard", "data=2"])
    split = capfd.readouterr().out
    assert "mesh={'data': 2, 'model': 1})" in split.splitlines()[0]
    assert split.strip().splitlines()[-1] == (
        "  mesh {'data': 2, 'model': 1}: each rank's forwards run 2 of the "
        "4 slots")
    tlaunch.main(args)
    meshless = capfd.readouterr().out
    assert _report(split) == _report(meshless)
    assert "prefix cache: " in meshless


# ---------------------------------------------------------------------------
# the slot split over `data`
# ---------------------------------------------------------------------------

_REFS: dict = {}


def _meshless_split(which, case):
    """The meshless run of a SPLIT case, once: the reference's
    (`which` "jax": streams and snapshot) or the port's ("port": also
    the rows and MoE drops, through `split_serve`)."""
    jc, jq, tc, tq, waves, kw, _ = case
    key = (which, id(case))
    if key not in _REFS:
        if which == "port":
            _REFS[key] = split_serve(tc, tq, waves, "cpu", **kw)
        else:
            eng = JEngine(jc, jq, **kw)
            results, streams = [], []
            for wave in waves:
                reqs = [eng.submit(p, n) for p, n in wave]
                results += eng.run()
                streams += [list(r.out_tokens) for r in reqs]
            _REFS[key] = {"streams": streams,
                          "snap": engine_snapshot(eng, results)}
            eng.close()
    return _REFS[key]


@pytest.mark.parametrize("name,spec", [(n, m) for n, c in SPLIT.items()
                                       for m in c[3]])
def test_data_split_equals_meshless(all_ranks, split_cases, name, spec):
    """Each data rank runs its block of the slots (S/n rows a forward;
    all of them when n does not divide S), with `check_invariants`; the
    streams, results, telemetry and counters on every rank equal the
    reference's meshless Engine's, the MoE drops the port's meshless
    Engine's, and the data ranks' pools are bit-equal."""
    case = split_cases[name]
    kw = case[5]
    runs = [o["split"][f"{name}@{spec}"] for o in all_ranks]
    jax_ref = None if name in SAMPLED else _meshless_split("jax", case)
    port_ref = _meshless_split("port", case)
    n = 4 if spec == "data=4" else 2
    slots = kw["num_slots"]
    want_rows = slots // n if slots % n == 0 else slots
    for r, run in enumerate(runs):
        assert run["rank_slots"] == want_rows, (r, run["rank_slots"])
        assert run["rows"] == [want_rows], (r, run["rows"])
        assert run["checks"] > 0 or kw.get("kv_layout") == "dense"
        assert run["streams"] == port_ref["streams"], r
        assert run["snap"] == port_ref["snap"], r
        assert run["drops"] == port_ref["drops"], r
        if jax_ref is not None:
            assert run["streams"] == jax_ref["streams"], r
            assert run["snap"] == jax_ref["snap"], r
    assert port_ref["rows"] == [slots]
    if name.startswith("moe_global"):
        assert port_ref["drops"] > 0
    if name in ("gqa_prefix_ngram", "gqa_int8", "mla"):
        assert port_ref["snap"]["prefix"]["hits"] >= 2
    if kw.get("draft_len"):
        assert port_ref["snap"]["spec"][0] > 0
    # the data ranks of one model index hold bit-equal pools
    by_model = {}
    for run in runs:
        by_model.setdefault(run["coords"].get("model", 0), set()).add(
            run["digest"])
    assert all(len(d) == 1 for d in by_model.values()), by_model
    if kw.get("kv_layout") == "dense":
        assert by_model == {0: {None}} or all(d == {None}
                                              for d in by_model.values())


def test_data_split_rows_equal_the_dry_run(all_ranks):
    """The dry run's per-rank serve batch under `--mesh data=2` is the
    live Engine's `rank_slots` on data=2,model=2 (one rule,
    `sharding.data_rows`), for 4 slots, which split, and 3, which do
    not."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cfg = get_config("granite-8b", smoke=True)
    for name, slots in (("gqa_prefix_ngram", 4), ("slots3", 3)):
        live = {o["split"][f"{name}@data=2,model=2"]["rank_slots"]
                for o in all_ranks}
        rec = dryrun.predict(cfg, {"kind": "decode", "batch": slots,
                                   "seq": 32}, 8, "data=2")
        assert live == {rec["batch_per_dev"]}, (name, live, rec)
    assert live == {3}


def test_all_gather_many_on_a_dry_group():
    """`comm.all_gather_many` over a dry-run group: each tensor's meta
    result has its rows times the group's size and keeps its dtype; the
    exchange counts as one all-gather of all their bytes, along the
    group's axis; without a group it hands the tensors back."""
    mesh = shd.dry_mesh("data=2")
    group = mesh.group("data")
    ts = [torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
          torch.empty((3,), dtype=torch.int32, device="meta"),
          torch.empty((6, 2, 2), dtype=torch.int8, device="meta")]
    comm.stats.reset()
    got = comm.all_gather_many(ts, group)
    assert [(tuple(g.shape), g.dtype) for g in got] == [
        ((6, 4), torch.bfloat16), ((6,), torch.int32), ((12, 2, 2),
                                                        torch.int8)]
    assert comm.stats.kind_calls == {"all-gather": 1}
    assert comm.stats.kind_bytes == {"all-gather": 2 * (24 + 12 + 24)}
    assert comm.stats.axis_calls == {"data": 1}
    assert comm.all_gather_many(ts, None) == ts
    assert shd.data_rows(4, mesh) == (0, 2) and shd.data_rows(3, mesh) == \
        (0, 3)
