"""The port's mesh Engine for the MLA, mamba, mLSTM and sLSTM layers and
the 2-bit model drafter under a mesh (`Engine(mesh=...)`).

The ranks are spawned once for the file (4 gloo ranks on the CPU,
`_torch_parallel_ranks.mixers_rank`).  On "data=1,model=2" (ranks 0 and
1) they serve the smoke configs at 8 bits: minicpm3-4b (MLA), xlstm-1.3b
(mLSTM and sLSTM), jamba-1.5-large-398b (mamba, its attention layer, its
MoE through the EP route) and granite-8b with the 2-bit model drafter;
jamba once more on "data=2,model=2" over all four.  Greedy streams equal
the port's meshless Engine's with the same options and, for xlstm-1.3b
and jamba (whose meshless 8-bit streams tests/test_torch_recurrent.py
holds to the reference's), the reference's meshless Engine's on the same
weights (drawn by `JM.init_params`, converted through numpy).  The smoke
xlstm-1.3b's sLSTM width, int(4/3 x 64) = 85, does not split two ways, so
its runs take `slstm_proj_factor=1.5` (width 96) in both packages; the
refusal of 85 is a test of its own.  Each sharded block (sequence, step,
and the state reassembled over the ranks) equals the meshless block bit
for bit.  The name rules equal the reference's for every leaf of the
three smoke trees, the leaves the port keeps whole are named, the grouped
column splits give rank r block r of every part, and non-dividing widths
and packed rows raise ValueError.  Training under a model axis takes
these layer kinds, and still refuses a pod axis, and the dry run's
`--mesh model=2` writes ok serve records for xlstm-1.3b and jamba with
the collectives the mesh Engine makes."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import mixers_rank, serve_streams
from repro.core import bramac_linear as jbl
from repro.models import model as JM
from repro.parallel import sharding as jshd
from repro.runtime.serve import Engine as JEngine
from repro_torch.core import bramac_linear as tbl
from repro_torch.launch import dryrun
from repro_torch.models import model as TM
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import trainer as ttrainer
from repro_torch.tree import tree_items
from test_torch_convert import smoke_pair, to_torch

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

MB, XL, JB = "minicpm3-4b", "xlstm-1.3b", "jamba-1.5-large-398b"
XL_SPLIT = {"slstm_proj_factor": 1.5}    # sLSTM width 96: splits two ways

# name: (arch, cfg overrides, Engine kwargs, mesh, with the reference)
RUNS = {
    "minicpm3": (MB, {}, {}, "model=2", False),
    "xlstm": (XL, XL_SPLIT, {}, "model=2", True),
    "jamba": (JB, {}, {"prefix_cache": False}, "model=2", True),
    "jamba_dp": (JB, {}, {"prefix_cache": False}, "data=2,model=2", True),
    "granite_drafter": ("granite-8b", {}, {"draft_len": 2,
                                            "drafter": "model",
                                            "draft_bits": 2}, "model=2",
                        False),
}
BLOCKS = {"mla": (MB, {}), "mamba": (JB, {}), "mlstm": (XL, XL_SPLIT),
          "slstm": (XL, XL_SPLIT)}


def _waves(vocab, seed):
    """Two waves of two requests: the second admitted while slots are
    reused."""
    rng = np.random.default_rng(seed)
    return [[(list(rng.integers(1, vocab, 6)), 5),
             (list(rng.integers(1, vocab, 11)), 4)],
            [(list(rng.integers(1, vocab, 3)), 6),
             (list(rng.integers(1, vocab, 8)), 3)]]


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX cfg, JAX 8-bit tree or None, port cfg, port tree,
    waves, kwargs, mesh); one weight tree and one traffic per (arch,
    overrides), so jamba's two meshes share their meshless streams."""
    trees, out = {}, {}
    for name, (arch, over, kw, mesh, with_jax) in RUNS.items():
        jc, tc = smoke_pair(arch, quant_bits=8, **over)
        key = (arch, tuple(sorted(over.items())))
        i = list(dict.fromkeys(
            (a, tuple(sorted(o.items()))) for a, o, *_ in RUNS.values()
        )).index(key)
        if key not in trees:
            if with_jax:
                jq = jax.jit(lambda k, c=jc: jbl.tree_prepare_serving(
                    JM.init_params(c, k), c.quant))(jax.random.PRNGKey(0))
                trees[key] = (jq, to_torch(jq))
            else:
                trees[key] = (None, TM.init_params(
                    tc, torch.Generator().manual_seed(i), "cpu",
                    serving=tc.quant))
        jq, tq = trees[key]
        out[name] = (jc, jq, tc, tq, _waves(tc.vocab_size, i), kw, mesh)
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    runs = {name: (tc, tq, waves, kw, mesh)
            for name, (_, _, tc, tq, waves, kw, mesh) in cases.items()}
    blocks = {}
    for i, (kind, (arch, over)) in enumerate(BLOCKS.items()):
        _, tc = smoke_pair(arch, quant_bits=8, **over)
        blocks[kind] = (kind, tc, 20 + i)
    outs = comm.spawn(mixers_rank, 4, runs, blocks, device="cpu")
    for name, (*_, mesh) in runs.items():
        on = (0, 1, 2, 3) if mesh == "data=2,model=2" else (0, 1)
        for r in on:
            assert outs[r]["runs"][name] == outs[0]["runs"][name], (name, r)
    return outs


_MESHLESS: dict = {}


def _meshless(which, tc, tq, waves, kw, jc=None, jq=None):
    """The port's (`which` "port") or the reference's ("jax") meshless
    streams, computed once per arch, traffic and options."""
    key = (which, tc.name, repr(tc), repr(waves), repr(sorted(kw.items())))
    if key not in _MESHLESS:
        _MESHLESS[key] = serve_streams(tc, tq, waves, "cpu", **kw) \
            if which == "port" else _jax_streams(jc, jq, waves, kw)
    return _MESHLESS[key]


def _jax_streams(jc, jq, waves, kw):
    eng = JEngine(jc, jq, num_slots=2, max_seq=32, **kw)
    outs = []
    for wave in waves:
        reqs = [eng.submit(p, n) for p, n in wave]
        eng.run()
        outs += [list(r.out_tokens) for r in reqs]
    eng.close()
    return outs


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_streams_equal_meshless(ranks, cases, name):
    """Every rank's greedy streams equal the port's meshless Engine's with
    the same options (and the reference's where stated); no ctx is left
    behind.  The model drafter's streams also equal the meshless ones
    without speculation (A1)."""
    jc, jq, tc, tq, waves, kw, _ = cases[name]
    got = ranks[0]["runs"][name]
    assert [len(s) for s in got] == [n for w in waves for _, n in w]
    assert got == _meshless("port", tc, tq, waves, kw)
    if jq is not None:
        assert got == _meshless("jax", tc, tq, waves, kw, jc, jq)
    if kw.get("drafter") == "model":
        assert got == _meshless("port", tc, tq, waves, {})
    assert not ranks[0]["ctx_after"][name]


def test_rank_widths(ranks):
    """A rank of model=2 runs half the heads and half of each recurrent
    width; the drafter is the 2-bit model on the rank's heads."""
    w = ranks[1]["widths"]
    assert w["minicpm3"]["heads"] == 2
    assert (w["xlstm"]["heads"], w["xlstm"]["mlstm"],
            w["xlstm"]["slstm"]) == (2, 64, 48)
    assert w["jamba"]["mamba"] == 64 and w["jamba"]["heads"] == 2
    assert (w["granite_drafter"]["draft_heads"],
            w["granite_drafter"]["draft_bits"]) == (2, 2)


@pytest.mark.parametrize("part", ["seq", "step", "state"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_sharded_block_equals_meshless(ranks, kind, part):
    """The block on model=2 (8-bit weights, each rank its shards) equals
    the meshless block on the same weights, on both ranks, bit for bit:
    the sequence's output, the step's output after it, and the final
    state reassembled over the ranks (MLA: its latent cache, whole on
    every rank)."""
    for r in (0, 1):
        pair = ranks[r]["blocks"][kind][part]
        for want, got in (pair if part == "state" else [pair]):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


# --- rules and splits --------------------------------------------------------

WHOLE_ON_PURPOSE = {
    MB: {"embed/embedding"},
    XL: {"embed/embedding", "layers/pos7/mixer/w_gates",
         "layers/pos7/mixer/r_gates", "layers/pos7/mixer/w_up"},
    JB: {"embed/embedding"} | {f"layers/pos{i}/mixer/{w}"
                               for i in (0, 1, 2, 3, 5, 6, 7)
                               for w in ("w_bc", "w_dt_down", "w_dt_up")},
}


@pytest.mark.parametrize("arch", [MB, XL, JB])
def test_spec_for_equals_the_reference_and_whole_leaves(arch):
    """`spec_for` equals the reference's on every leaf path of the 8-bit
    smoke serving tree; the leaves with a split rule that the mesh Engine
    keeps whole (`serve_whole`) are exactly the named ones."""
    _, tc = smoke_pair(arch, quant_bits=8)
    tree = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                          serving=tc.quant)
    whole = set()
    for path, t in tree_items(tree):
        spec = shd.spec_for(path, t.ndim)
        assert spec == jshd.spec_for(path.replace("/", "."), t.ndim), path
        stem = re.sub(r"/(values|scale)$", "", path)
        if any(s is not None for s in spec) and any(
                re.search(p, stem) for p in shd.serve_whole(tc)):
            whole.add(stem)
    assert whole == WHOLE_ON_PURPOSE[arch]


def _mesh(i, n=2):
    return shd.ShardingCtx(shd.Mesh(("model",), (n,), (i,), {}),
                           shd.serve_rules(False))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("leaf,parts", [
    ("layers/pos0/mixer/w_in", 2), ("layers/pos0/mixer/w_up", 2),
    ("layers/pos7/mixer/w_up", 2), ("layers/pos7/mixer/w_gates", 4)])
def test_grouped_split_gives_block_r_of_each_part(leaf, parts, quantized):
    """Rank r's columns of a leaf that concatenates `parts` outputs are
    block r of each part, in part order (values and scales alike); a
    plain column-parallel leaf takes one contiguous block."""
    w = torch.randn((3, 16, 8 * parts), generator=torch.Generator(
        ).manual_seed(parts))
    q = tbl.QuantConfig(enabled=True, bits_w=8, bits_a=8)
    t = tbl.prepare_serving(w, q) if quantized else w
    tree = {}
    node = tree
    *heads, last = leaf.split("/")
    for k in heads:
        node = node.setdefault(k, {})
    node[last] = t
    for r in range(2):
        got = shd.shard_params(tree, _mesh(r))
        for k in heads:
            got = got[k]
        got = got[last]
        for whole, mine in ((t.values, got.values), (t.scale, got.scale)) \
                if quantized else ((t, got),):
            want = torch.cat([p[..., r * 4:(r + 1) * 4]
                              for p in whole.chunk(parts, -1)], -1)
            assert torch.equal(mine, want)
    plain = shd.shard_params({"mlp": {"w_up": w}}, _mesh(1))["mlp"]["w_up"]
    assert torch.equal(plain, w[..., 4 * parts:])


@pytest.mark.parametrize("arch,over,match", [
    (XL, {}, "slstm_width=85"),
    (XL, {"mlstm_proj_factor": 65 / 64, "slstm_proj_factor": 1.5},
     "mlstm_width=65"),
    (JB, {"mamba_expand": 1, "d_model": 63, "head_dim": 16},
     "mamba_d_inner=63")])
def test_non_dividing_widths_raise(arch, over, match):
    """A recurrent width that the model axis does not divide raises
    ValueError naming it."""
    _, tc = smoke_pair(arch, **over)
    with pytest.raises(ValueError, match=match):
        shd.local_config(tc, _mesh(0).mesh)


@pytest.mark.parametrize("arch,bits,over,leaf", [
    (XL, 4, {"slstm_proj_factor": 90 / 64}, "layers/pos7/mixer/w_down"),
    ("granite-8b", 2, {"d_ff": 108}, "layers/pos0/mlp/w_down")])
def test_packed_rows_that_do_not_split_raise(arch, bits, over, leaf):
    """A sub-byte row-parallel weight splits on its packed rows: the
    sLSTM's w_down of 90 rows at 4 bits (45 stored, 22.5 a rank) and a
    2-bit w_down of 108 rows (27 stored) raise ValueError naming the
    leaf, where the logical width itself splits."""
    _, tc = smoke_pair(arch, quant_bits=bits, **over)
    shd.local_config(tc, _mesh(0).mesh)
    tree = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                          serving=tc.quant)
    with pytest.raises(ValueError, match=re.escape(leaf)):
        shd.shard_params(tree, _mesh(0), whole=shd.serve_whole(tc))


# --- training these layers under a model axis --------------------------------

@pytest.mark.parametrize("arch", [MB, XL, JB])
def test_training_under_a_model_axis_refuses_the_layer_kinds(arch):
    """`trainer.check_mesh` takes these layer kinds on `model=2`, on
    `data=2,model=2` and on a data axis alone (they were refused under a
    model axis until tensor-parallel training of the mixers was ported:
    tests/test_torch_tp_mixers_trainer.py trains them), and still refuses
    a mesh axis other than `data` and `model` (a `pod` axis) by name."""
    _, tc = smoke_pair(arch)
    for spec in ("model=2", "data=2,model=2", "data=2"):
        ttrainer.check_mesh(tc, shd.dry_mesh(spec))
    with pytest.raises(NotImplementedError, match=re.escape("mesh axes {'pod': 2}")):
        ttrainer.check_mesh(tc, shd.dry_mesh("pod=2,model=2"))


# --- the dry run's serve cells on model=2 ------------------------------------

@pytest.mark.parametrize("arch,calls", [
    (XL, {"all-gather": 6 * 7 * 2 + 1, "all-reduce": 6 * 8 * 2}),
    (JB, {"all-gather": 9 * (7 * 2 + 4 * 3) + 1,
          "all-reduce": 9 * (1 + 4) * 2})])
def test_dry_run_serve_cells_on_model_2(arch, calls, tmp_path):
    """`launch.dryrun --mesh model=2` writes an ok serve_tp_q8 decode
    record for xlstm-1.3b (181 collectives a forward: the mLSTM's two
    gathers and its w_down's max and sum, the sLSTM's w_down, the logits'
    gather) and jamba-1.5-large-398b (325: mamba's two gathers, each
    row-parallel wo and w_down, three gathers an EP MoE FF); minicpm3-4b's
    249 is tests/test_torch_dryrun.py's."""
    dryrun.main(["--arch", arch, "--shape", "decode_32k", "--variant",
                 "serve_tp_q8", "--mesh", "model=2", "--out", str(tmp_path)])
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collective_calls_per_dev"] == calls
