"""The port's mesh Engine (`Engine(mesh=...)`: tensor-parallel attention
and dense FF, expert-parallel MoE) and `launch/serve.py --shard`.

The reference's own mesh Engine test fails under jax 0.9.0 (a
ShardingTypeError in `layers.embed` on the vocab-sharded embedding), so
the port's mesh Engine is held against the reference's meshless Engine —
the sharded Engine only partitions that function — and against the
port's own meshless Engine, on the same weights and submissions.  The
mesh Engines run on 4 gloo ranks on the CPU, spawned once for the file
(`_torch_parallel_ranks.engine_rank`): granite-8b smoke at 8 bits with
`mesh="model=2"` (the 4 ranks make it data=2 x model=2: two replicas of
a 2-way TP engine), fp KV through the gather oracle and int8 KV through
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
that raises), non-dividing head counts raise ValueError, and the layer
kinds the mesh path does not serve raise NotImplementedError."""
import jax
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import engine_rank, serve_streams
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
def ranks(cases):
    runs = {name: (tc, tq, waves, kw)
            for name, (_, _, tc, tq, waves, kw) in cases.items()}
    outs = comm.spawn(engine_rank, 4, runs, device="cpu")
    for other in outs[1:]:
        for name in RUNS:
            assert other[name] == outs[0][name], name
    return outs[0]


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
    """Layer kinds the mesh path does not serve raise NotImplementedError
    naming the kind, and leave no sharding ctx active."""
    _, tc = smoke_pair(arch)
    with pytest.raises(NotImplementedError, match=kind):
        TEngine(tc, {}, num_slots=1, max_seq=16, mesh="model=1",
                device="cpu")
    assert shd.active() is None


def test_mesh_refuses_model_drafter():
    _, tc = smoke_pair()
    with pytest.raises(NotImplementedError, match="drafter"):
        TEngine(tc, {}, num_slots=1, max_seq=16, mesh="model=1",
                draft_len=2, drafter="model", device="cpu")
    assert shd.active() is None


def test_launcher_shard_on_the_cpu(capfd):
    """`--shard 2` spawns 2 ranks; rank 0 prints the reference's report
    lines, naming the mesh (the ranks write to this process's stdout)."""
    tlaunch.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                  "--shard", "2", "--quant-bits", "8", "--requests", "3",
                  "--new-tokens", "4"])
    out = capfd.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("3/3 requests done, 12 tokens in ")
    assert "mesh={'data': 1, 'model': 2})" in lines[0]
    assert "decode_kernel=off" in out
