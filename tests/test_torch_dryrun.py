"""The port's dry run (`repro_torch.launch.{device,specs,analysis,
counting,dryrun}`) against the JAX package's (`repro.launch.{specs,
analysis,dryrun}`) on the CPU: the meta stand-ins leaf for leaf against
`jax.eval_shape` at every arch's full config, the analytic floors for all
40 cells, counted FLOPs against a sum written out by hand, per-period
counting against the whole stack, the sLSTM recurrence against the
reference's analytic correction, the 145 collectives of a tensor-parallel
granite-8b decode, the cells the port refuses, the records' roofline
terms, and the CLI."""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.configs import get_config as jget_config
from repro.core import bramac_linear as jbl
from repro.launch import analysis as janalysis
from repro.launch import specs as jspecs
from repro_torch.configs import archs, get_config
from repro_torch.kernels.bramac_matmul import bramac_matmul
from repro_torch.launch import analysis, dryrun, specs
from repro_torch.launch import device as dev
from repro_torch.launch.counting import Counter
from repro_torch.models import attention
from repro_torch.tree import tree_items
from test_torch_convert import smoke_pair

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

ARCHS = list(archs.FULL)


def _jax_items(tree):
    """(path, shape, dtype name) of every array of a JAX shape tree, paths
    named as `repro_torch.tree` names them."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path]
        out.append(("/".join(parts), tuple(leaf.shape),
                    np.dtype(leaf.dtype).name))
    return sorted(out)


def _torch_items(tree):
    return sorted((path, tuple(t.shape), str(t.dtype).split(".")[-1])
                  for path, t in tree_items(tree))


def _nbytes(items):
    return sum(math.prod(s) * (2 if d == "bfloat16" else np.dtype(d).itemsize)
               for _, s, d in items)


# --- stand-ins ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_equal_jax_eval_shape(arch):
    """`input_specs` of a train_4k and a decode_32k cell (bf16 params, the
    AdamW state, the batch, the caches, tokens and positions), the q8 and
    q4 serving trees and the prefill batch: each leaf's path, shape and
    dtype, and the totals in bytes, equal the reference's
    `jax.eval_shape` stand-ins at the full config."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    pairs = [(jspecs.input_specs(arch, shape), specs.input_specs(arch, shape))
             for shape in ("train_4k", "decode_32k")]
    jp = pairs[0][0]["params"]
    for bits in (8, 4):
        q = jbl.QuantConfig(enabled=True, bits_w=bits, bits_a=8)
        pairs.append((jax.eval_shape(
            lambda p, q=q: jbl.tree_prepare_serving(p, q), jp),
            specs.param_specs(tcfg, bits)))
    pairs.append((jspecs.batch_specs(jcfg, "prefill_32k"),
                  specs.batch_specs(tcfg, "prefill_32k")))
    for want, got in pairs:
        w, g = _jax_items(want), _torch_items(got)
        assert g == w
        assert _nbytes(g) == _nbytes(w)
    assert all(t.is_meta for _, t in tree_items(pairs[0][1]))


# --- analysis ----------------------------------------------------------------

def test_analysis_equals_the_reference_for_all_40_cells():
    """kv_cache_bytes and min_bytes_per_dev of every cell equal the
    reference's, at its defaults (256 chips, 16-way model) and at one
    card; the memory term is over the card's HBM rate."""
    assert len(archs.all_cells()) == 40
    assert archs.all_cells() == jarchs.all_cells()
    for arch, shape in archs.all_cells():
        info = archs.SHAPES[shape]
        assert analysis.kv_cache_bytes(get_config(arch), info["batch"],
                                       info["seq"]) == \
            janalysis.kv_cache_bytes(jget_config(arch), info["batch"],
                                     info["seq"])
        for kw in ({"chips": 256, "model_par": 16},
                   {"chips": 1, "model_par": 1}):
            assert analysis.min_bytes_per_dev(arch, shape, **kw) == \
                janalysis.min_bytes_per_dev(arch, shape, **kw)
        assert analysis.min_bytes_per_dev(arch, shape) == \
            janalysis.min_bytes_per_dev(arch, shape, chips=1, model_par=1)
        assert analysis.min_memory_term(arch, shape) == \
            analysis.min_bytes_per_dev(arch, shape) / 3.35e12


def test_card_constants():
    """The H100's data-sheet peaks; without a card, card() is its sheet."""
    c = dev.H100
    assert (c.name, c.power_limit_w) == ("NVIDIA H100 80GB HBM3", 700.0)
    assert (c.bf16_flops_per_s, c.int8_ops_per_s, c.fp32_flops_per_s,
            c.hbm_bytes_per_s) == (989e12, 1979e12, 67e12, 3.35e12)
    assert c.peak("int") == 1979e12 and c.peak("bf16") == 989e12
    if not torch.cuda.is_available():
        assert dev.card() == c


# --- FLOPs -------------------------------------------------------------------

def _granite_flops_by_hand(cfg, B, S):
    """A granite prefill's FLOPs written out per matmul: (linear FLOPs,
    attention FLOPs); the last position alone is unembedded."""
    d, H, Hkv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab_size)
    M = B * S
    per_layer = 2 * M * d * H * hd + 2 * (2 * M * d * Hkv * hd) \
        + 2 * M * H * hd * d + 3 * (2 * M * d * ff)
    linears = cfg.num_layers * per_layer + 2 * B * d * V
    assert S <= attention.Q_CHUNK               # one query chunk
    attn = cfg.num_layers * 2 * (2 * B * H * S * S * hd)
    return linears, attn


@pytest.mark.parametrize("bits", [0, 8])
def test_counted_flops_equal_a_sum_by_hand(bits):
    """granite's smoke prefill (f32): every linear and the unembed as
    2·M·N·K (the kernel's operations when quantized), the attention
    einsums as two batched products; the kernel is called 7 x layers + 1
    times."""
    _, cfg = smoke_pair()
    info = {"kind": "prefill", "batch": 2, "seq": 12}
    c = dryrun.count_step(cfg, info, bits)
    linears, attn = _granite_flops_by_hand(cfg, 2, 12)
    if bits:
        assert c["flops"] == {"f32": attn, "int": linears}
        assert c["kernel_calls"] == 7 * cfg.num_layers + 1
    else:
        assert c["flops"] == {"f32": attn + linears, "int": 0}
        assert c["kernel_calls"] == 0


def _smoke_4(arch):
    """The smoke config at four periods, widened so that every stacked
    leaf's AdamW moment fills whole 128-value blocks per period, as every
    full config's leaves do (a Q8 moment's padding is then affine in the
    number of periods)."""
    cfg = get_config(arch, smoke=True)
    return cfg.replace(num_layers=4 * len(cfg.layer_pattern), d_model=128,
                       d_ff=cfg.d_ff and 256, moe_d_ff=cfg.moe_d_ff and 128)


SCALE_CASES = [("granite-8b", "train", 0), ("granite-8b", "decode", 8),
               ("qwen3-moe-30b-a3b", "prefill", 8),
               ("qwen3-moe-30b-a3b", "train", 0),
               ("xlstm-1.3b", "prefill", 0), ("xlstm-1.3b", "train", 0),
               ("jamba-1.5-large-398b", "prefill", 4),
               ("jamba-1.5-large-398b", "decode", 0)]


@pytest.mark.parametrize("arch,kind,bits", SCALE_CASES)
def test_per_period_count_equals_whole_stack(arch, kind, bits):
    """Two and three periods scaled to four equal the four-period stack
    counted whole: FLOPs, bytes, ops, kernel calls, collectives, argument
    and output bytes, and each phase's peak.  Rounded to the allocator's
    512-byte granule, a small stacked leaf (a (periods, 128) norm scale)
    rounds to the same granule at two periods as at one, so the rounded
    peaks agree to a few granules."""
    cfg = _smoke_4(arch)
    info = {"kind": kind, "batch": 2, "seq": 1 if kind == "decode" else 16}
    scaled, how = dryrun.count(cfg, info, bits, probe="on")
    whole, how_w = dryrun.count(cfg, info, bits, probe="off")
    assert (how, how_w) == ("per_period", "whole_stack")
    for key in ("flops", "bytes", "ops", "kernel_calls", "args", "output",
                "alias", "mm_flops", "coll_calls", "coll_bytes", "peaks",
                "peak"):
        assert scaled[key] == whole[key], key
    for a, b in zip(scaled["peaks_rounded"], whole["peaks_rounded"],
                    strict=True):
        assert abs(a - b) <= 32 * 512


def test_scaled_training_peak_is_a_lower_bound():
    """Deeper in, a training step's backward peak outgrows the line
    through two and three periods (jamba at four widened smoke periods:
    each phase's scaled peak is at most the whole stack's, the backward's
    below it), so "auto" counts training whole and scales a prefill only,
    and a record of a scaled training count marks its peak a lower bound
    and does not say whether it fits the card."""
    cfg = _smoke_4("jamba-1.5-large-398b")
    info = {"kind": "train", "batch": 2, "seq": 16}
    scaled, how = dryrun.count(cfg, info, probe="on")
    whole, how_w = dryrun.count(cfg, info)
    assert (how, how_w) == ("per_period", "whole_stack")
    assert all(a <= b for a, b in zip(scaled["peaks"], whole["peaks"],
                                       strict=True))
    assert scaled["peaks"][1] < whole["peaks"][1]
    assert scaled["flops"] == whole["flops"]
    assert scaled["bytes"] == whole["bytes"]
    low = dryrun.record(cfg, info, scaled, how, 1, dev.H100)["memory"]
    assert low["peak_is_lower_bound"] and "fits_card" not in low
    mem = dryrun.record(cfg, info, whole, how_w, 1, dev.H100)["memory"]
    assert mem["fits_card"] and "peak_is_lower_bound" not in mem
    prefill = {"kind": "prefill", "batch": 2, "seq": 4}
    assert dryrun.count(cfg, prefill)[1] == "per_period"


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_slstm_recurrence_counted_against_the_reference_correction(kind):
    """xlstm's sLSTM R·h products are counted at every step: at prefill,
    the counted FLOPs less one step a layer equal the reference's
    `_slstm_scan_correction` exactly; at train the port counts the forward
    product at every step and the two backward products at every step but
    the first one's input gradient (the initial state is a constant):
    3S - 1 products a layer, where the reference adds 4 (S - 1) (forward,
    remat, two backward).  (The vocabulary is moved off 4d, which the
    unembed's product would otherwise share at the smoke width.)"""
    from repro.launch import dryrun as jdryrun
    jcfg, tcfg = smoke_pair("xlstm-1.3b", vocab_size=320)
    B, S = 2, 12
    info = {"kind": kind, "batch": B, "seq": S}
    c, _ = dryrun.count(tcfg, info)
    rec = dryrun.record(tcfg, info, c, "whole_stack", 1, dev.H100)
    got = rec["slstm_rh_flops"]
    ref = jdryrun._slstm_scan_correction(jcfg, info)
    assert got["reference_correction"] == ref
    n_slstm = tcfg.n_periods
    step = 2 * B * tcfg.d_model * 4 * tcfg.d_model
    if kind == "prefill":
        assert got["counted"] - n_slstm * step == ref
    else:
        assert got["counted"] == (3 * S - 1) * n_slstm * step
        assert ref == 4 * n_slstm * (S - 1) * step
    decode = {"kind": "decode", "batch": B, "seq": 1}
    assert jdryrun._slstm_scan_correction(jcfg, decode) == 0.0
    assert "slstm_rh_flops" not in dryrun.record(
        tcfg, decode, dryrun.count(tcfg, decode)[0], "whole_stack", 1,
        dev.H100)


def test_fast_meta_route_equals_the_reference_meta_functions():
    """The memoized meta results give the same counts as every op run
    through its reference meta function, on a jamba train step."""
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    info = {"kind": "train", "batch": 2, "seq": 8}
    got = []
    for fast in (True, False):
        params, opt = specs.state_specs(cfg, dryrun.OPT_CFG)
        for _, p in tree_items(params):
            p.requires_grad_(True)
        batch = specs.batch_specs(cfg, info)
        counter = Counter(fast=fast)
        counter.track((params, opt, batch))
        with counter:
            dryrun.make_train_step(cfg)(params, opt, batch)
        got.append((dict(counter.flops), counter.bytes, counter.ops,
                    counter.peak, counter.peak_rounded))
    assert got[0] == got[1]


def test_kernel_meta_route_counts_and_allocates_like_cuda():
    """bramac_matmul on meta: the output's shape and dtype, the int32
    accumulator's bytes live, 2·M·N·K operations; no launch counted; the
    decode kernels and mac2 refuse meta operands by name."""
    from repro_torch.kernels import mac2_kernel, paged_attention
    M, K, N = 5, 96, 40
    x = torch.empty((M, K), dtype=torch.int8, device="meta")
    w = torch.empty((K, N), dtype=torch.int8, device="meta")
    xs = torch.empty((M, 1), device="meta")
    ws = torch.empty((1, N), device="meta")
    launches = bramac_matmul.launches
    c = Counter()
    with c:
        y = bramac_matmul(x, w, xs, ws, bits_a=8, bits_w=8,
                          out_dtype=torch.bfloat16)
    assert (tuple(y.shape), y.dtype, y.is_meta) == ((M, N),
                                                     torch.bfloat16, True)
    assert c.kernel_calls == 1 and c.flops["int"] == 2 * M * N * K
    assert bramac_matmul.launches == launches
    assert c.peak >= M * N * 4 + M * N * 2       # the int32 acc and y
    with pytest.raises(ValueError, match="meta"):
        mac2_kernel.mac2_mvm_kernel(w, w[0], bits=8)
    q = torch.empty((1, 4, 16), device="meta")
    pool = torch.empty((4, 16, 2, 16), device="meta")
    i32 = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        paged_attention.paged_decode(q, pool, pool, i32, i32[:, 0],
                                     i32[:, 0])


# --- collectives and refusals ------------------------------------------------

def test_tp_granite_decode_counts_145_collectives():
    """granite-8b decode_32k, serve_tp_q8 on `model=2` (per rank): per
    layer wo's and w_down's absmax max and int32 sum, one gather of the
    logits: 36 x 2 x 2 + 1 = 145, with bytes as derived."""
    rec = dryrun.run_cell("granite-8b", "decode_32k", "serve_tp_q8",
                          mesh="model=2")
    cfg = get_config("granite-8b")
    B, L, d, V = 128, cfg.num_layers, cfg.d_model, cfg.vocab_size
    assert rec["status"] == "ok" and rec["ranks"] == 2
    assert rec["collective_calls_per_dev"] == {"all-reduce": 4 * L,
                                               "all-gather": 1}
    # the bf16 rows' absmax (B, 1), the int32 partials (B, d), the bf16
    # logits (B, V)
    assert rec["collective_bytes_per_dev"] == {
        "all-reduce": L * 2 * (B * 2 + B * d * 4),
        "all-gather": B * V * 2}
    assert rec["kernel_calls_per_dev"]["bramac_matmul"] == 7 * L + 1
    assert rec["roofline"]["collective_s"] is None


@pytest.mark.parametrize("arch,shape,variant,mesh,match", [
    ("granite-8b", "train_4k", "baseline", "model=2",
     "tensor-parallel training"),
    ("minicpm3-4b", "decode_32k", "serve_tp_q8", "model=2",
     "'mla\\+dense' layer under a mesh"),
    ("granite-8b", "decode_32k", "cache_seq_q8", None, "KV layout"),
    ("granite-8b", "train_4k", "no_remat", None, "no remat")])
def test_refused_cells_record_the_port_error(tmp_path, capsys, arch, shape,
                                             variant, mesh, match):
    argv = ["--arch", arch, "--shape", shape, "--variant", variant,
            "--out", str(tmp_path)]
    dryrun.main(argv + (["--mesh", mesh] if mesh else []))
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "error"
    assert __import__("re").search(match, rec["error"])
    assert ": error" in capsys.readouterr().out


# --- records and the CLI -----------------------------------------------------

def test_variants_table_is_wellformed():
    """Every variant keeps granite's 36 layers or refuses by name; rules
    are the default or the serve set; bits in (0, 2, 4, 8); the
    reference's names are all there."""
    from repro.launch import dryrun as jdryrun
    assert set(dryrun.VARIANTS) == set(jdryrun.VARIANTS)
    for name, (transform, rules, qbits) in dryrun.VARIANTS.items():
        try:
            cfg = transform(get_config("granite-8b"))
        except NotImplementedError as e:
            assert "cache_seq" in name or "no_remat" in name, e
            continue
        assert cfg.num_layers == 36
        assert rules in (None, "serve")
        assert qbits in (0, 2, 4, 8)


def test_records_consistent(tmp_path, capsys):
    """The CLI writes a record per cell (a second call skips it); each
    ok record's roofline terms recompute from its counters and the card's
    peaks; long_500k of a full-attention arch is skipped by design."""
    argv = ["--arch", "granite-8b", "--shape", "all", "--variant", "q8",
            "--out", str(tmp_path)]
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert out.count("[done]") == 3 and "[skip by design]" in out
    dryrun.main(argv)
    assert capsys.readouterr().out.count("[skip existing]") == 4
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert sorted(r["status"] for r in recs) == ["ok", "ok", "ok",
                                                 "skipped"]
    card = dev.H100
    for r in recs:
        if r["status"] != "ok":
            continue
        ro, mem = r["roofline"], r["memory"]
        compute = sum(n / card.peak(k)
                      for k, n in r["flops_by_class_per_dev"].items())
        assert abs(ro["compute_s"] - compute) < 1e-9
        assert abs(ro["memory_s"]
                   - r["bytes_per_dev"] / card.hbm_bytes_per_s) < 1e-9
        assert ro["dominant"] == max(
            ("compute", ro["compute_s"]), ("memory", ro["memory_s"]),
            key=lambda kv: kv[1])[0]
        assert 0 < ro["roofline_fraction"] <= 1.0
        assert ro["flops_global"] == r["flops_per_dev"]
        assert mem["peak_est_bytes_per_dev"] == (
            mem["args_bytes_per_dev"] + mem["output_bytes_per_dev"]
            + mem["temp_bytes_per_dev"] - mem["alias_bytes_per_dev"])
        assert mem["card_memory_bytes"] == card.memory_bytes
        calls = r["kernel_calls_per_dev"]["bramac_matmul"]
        assert (calls > 0) == (r["shape"] != "train_4k")   # q8 serves
        assert r["count_s"] >= 0 and r["cost_probe"] == "whole_stack"
    assert os.path.getsize(tmp_path / "granite-8b__long_500k__card__q8.json")
