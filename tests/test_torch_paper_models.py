"""The port's copies of the paper's analytical models (`repro_torch.core.
{efsm,arch_models,workloads,gemv_model,dla_model}`) vs the JAX package's
modules on the same arguments, the port's reproduced quantities vs the
deterministic rows of `benchmarks/baseline.json`, and the paper launcher
(`python -m repro_torch.launch.paper --device cpu`) vs
`examples/gemv_paper_repro.py` and `examples/quickstart.py`'s `demo_mac2`.

`case_study()` takes some 20 s of pure Python a side, so each side computes
it once per module; the launcher's subprocess is started before them and
runs alongside."""
import contextlib
import dataclasses
import io
import json
import os
import runpy
import subprocess
import sys

import jax
import pytest
import torch

from repro.core import arch_models as jam
from repro.core import dla_model as jdla
from repro.core import efsm as jefsm
from repro.core import gemv_model as jgm
from repro.core import workloads as jwl
from repro_torch.core import arch_models as tam
from repro_torch.core import dla_model as tdla
from repro_torch.core import efsm as tefsm
from repro_torch.core import gemv_model as tgm
from repro_torch.core import workloads as twl
from repro_torch.launch import paper

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # smoke sizes: one intra-op thread per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = (2, 4, 8)


def _same(a, b):
    """Dataclass values of the two packages compare by fields."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and \
            dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


def _pairs():
    """(JAX, port) object pairs of every architecture the models name."""
    return [(jefsm.BRAMAC_2SA, tefsm.BRAMAC_2SA),
            (jefsm.BRAMAC_1DA, tefsm.BRAMAC_1DA),
            (jam.CCB, tam.CCB), (jam.COMEFA_D, tam.COMEFA_D),
            (jam.COMEFA_A, tam.COMEFA_A)]


@pytest.fixture(scope="module")
def cli_proc():
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.paper", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_case_study():
    return jdla.case_study()


@pytest.fixture(scope="module")
def port_case_study():
    return tdla.case_study()


def test_launcher_prints_the_example_sections(cli_proc, jax_case_study,
                                              port_case_study):
    """The launcher's five sections are the example's lines, its MAC2 demo
    is quickstart's, and its 105 Fig 11 GEMVs are bit-exact.  The JAX
    example runs in this process on the module's case study."""
    example = runpy.run_path(os.path.join(REPO, "examples",
                                          "gemv_paper_repro.py"))
    quick = runpy.run_path(os.path.join(REPO, "examples", "quickstart.py"))
    buf = io.StringIO()
    orig = jdla.case_study
    jdla.case_study = lambda: jax_case_study
    try:
        with contextlib.redirect_stdout(buf):
            for section in ("table2", "fig9", "fig10", "fig11", "fig13"):
                example[section]()
            quick["demo_mac2"]()
    finally:
        jdla.case_study = orig
    want = buf.getvalue().splitlines()
    out, err = cli_proc.communicate(timeout=300)
    assert cli_proc.returncode == 0, err[-3000:]
    got = out.splitlines()
    assert got[:len(want)] == want
    assert got[len(want):] == [
        "=== Fig 11 GEMVs through the dummy-array MAC2 kernel ===",
        "  105 MVMs (R in (64, 96, 128, 160, 256, 320, 512) x C in "
        "(128, 160, 256, 320, 480) x 2/4/8-bit, signed, seed 0) bit-exact "
        "vs w @ x: max|err| = 0"]


def test_case_study_matches_jax(jax_case_study, port_case_study):
    """Fig 13: every explored configuration and its statistics."""
    assert port_case_study.keys() == jax_case_study.keys()
    for key, row in jax_case_study.items():
        assert port_case_study[key].keys() == row.keys()
        for name, (cfg, stats) in row.items():
            tcfg, tstats = port_case_study[key][name]
            assert _same(tcfg, cfg), (key, name)
            assert tstats == stats, (key, name)
    assert tdla.average_speedups(port_case_study) == \
        jdla.average_speedups(jax_case_study)


def test_derived_rows_match_baseline(port_case_study):
    """Every deterministic table2_*/fig*_* row of benchmarks/baseline.json
    comes out of the port as the same string."""
    with open(os.path.join(REPO, "benchmarks", "baseline.json")) as f:
        records = json.load(f)["records"]
    want = {r["name"]: r["derived"] for r in records if r["deterministic"]
            and r["name"].split("_")[0] in
            ("table2", "fig7", "fig9", "fig10", "fig11", "fig13")}
    assert len(want) == 23
    assert paper.derived_rows(port_case_study) == want


def test_efsm_matches_jax():
    assert (tefsm.ROW_BITS, tefsm.PORT_BITS) == (jefsm.ROW_BITS,
                                                jefsm.PORT_BITS)
    assert tefsm.VARIANTS.keys() == jefsm.VARIANTS.keys()
    for j, t in _pairs()[:2]:
        assert _same(t, j)
        assert t.readout_busy_cycles() == j.readout_busy_cycles()
        for bits in BITS:
            for signed in (True, False):
                assert t.mac2_latency(bits, signed) == \
                    j.mac2_latency(bits, signed)
                assert t.macs_per_cycle(bits, signed) == \
                    j.macs_per_cycle(bits, signed)
            assert t.mac2_lanes(bits) == j.mac2_lanes(bits)
            assert t.macs_in_parallel(bits) == j.macs_in_parallel(bits)
            assert t.max_dot_product_macs(bits) == j.max_dot_product_macs(bits)
        with pytest.raises(ValueError):
            t.mac2_latency(3)


def test_arch_models_matches_jax():
    assert _same(tam.ARRIA10, jam.ARRIA10)
    assert tam.ARRIA10.dsp_rel_area == jam.ARRIA10.dsp_rel_area
    assert tam.DSP_MACS_PER_MULT == jam.DSP_MACS_PER_MULT
    assert tam.LB_TOTAL_MACS_PER_S == jam.LB_TOTAL_MACS_PER_S
    assert _same(tam.EDSP, jam.EDSP) and _same(tam.PIR_DSP, jam.PIR_DSP)
    for j, t in _pairs()[2:]:
        assert _same(t, j) and t.fmax_mhz == j.fmax_mhz
        for bits in BITS:
            assert t.mac_cycles(bits) == j.mac_cycles(bits)
            assert t.macs_per_cycle(bits) == j.macs_per_cycle(bits)
    for bits in BITS:
        assert tam.dsp_throughput(bits) == jam.dsp_throughput(bits)
        assert tam.lb_throughput(bits) == jam.lb_throughput(bits)
        assert tam.peak_throughput(bits) == jam.peak_throughput(bits)
        for j, t in _pairs():
            assert tam.bram_throughput(t, bits) == jam.bram_throughput(j, bits)
            assert tam.peak_throughput(bits, t) == jam.peak_throughput(bits, j)
            assert tam.throughput_boost(bits, t) == \
                jam.throughput_boost(bits, j)
        for jd, td in ((jam.EDSP, tam.EDSP), (jam.PIR_DSP, tam.PIR_DSP)):
            assert tam.peak_throughput(bits, None, td) == \
                jam.peak_throughput(bits, None, jd)
    assert tam.utilization_table() == jam.utilization_table()
    assert tam.utilization_advantage() == jam.utilization_advantage()
    for p in range(1, 17):
        assert tam.comefa_utilization(p) == jam.comefa_utilization(p)
        for pack in (1, 2, 4):
            assert tam.ccb_utilization(p, pack) == jam.ccb_utilization(p, pack)
    assert tam.ADDERS == jam.ADDERS
    for kind in tam.ADDERS:
        for bits in range(1, 65):
            assert tam.adder_delay_ps(kind, bits) == \
                jam.adder_delay_ps(kind, bits)
    assert (tam.DUMMY_ARRAY_AREA_UM2, tam.DUMMY_ARRAY_AREA_OVERHEAD,
            tam.EFSM_AREA_UM2) == (jam.DUMMY_ARRAY_AREA_UM2,
                                   jam.DUMMY_ARRAY_AREA_OVERHEAD,
                                   jam.EFSM_AREA_UM2)


def test_workloads_matches_jax():
    assert twl.MODELS.keys() == jwl.MODELS.keys()
    for name, layers in jwl.MODELS.items():
        assert len(twl.MODELS[name]) == len(layers)
        for j, t in zip(layers, twl.MODELS[name]):
            assert _same(t, j) and (t.macs, t.weights) == (j.macs, j.weights)


def test_gemv_model_matches_jax():
    """Fig 11: the cycle models over the whole grid, every speedup grid
    and the headline maxima."""
    assert (tgm.ROW_SIZES, tgm.COL_SIZES, tgm.T_RED_COEF) == \
        (jgm.ROW_SIZES, jgm.COL_SIZES, jgm.T_RED_COEF)
    assert tgm.COMPETITORS.keys() == jgm.COMPETITORS.keys()
    for bits in BITS:
        assert tgm.reduction_cycles(bits) == jgm.reduction_cycles(bits)
        for R in tgm.ROW_SIZES:
            for C in tgm.COL_SIZES:
                for j, t in _pairs()[:2]:
                    for signed in (True, False):
                        assert _same(tgm.bramac_gemv(t, R, C, bits, signed),
                                     jgm.bramac_gemv(j, R, C, bits, signed))
                for j, t in _pairs()[2:]:
                    for pack in (1, 2, 4):
                        assert _same(tgm.bitserial_gemv(t, R, C, bits, pack),
                                     jgm.bitserial_gemv(j, R, C, bits, pack))
                    assert _same(
                        tgm.bitserial_gemv(t, R, C, bits, streams_input=True),
                        jgm.bitserial_gemv(j, R, C, bits, streams_input=True))
                for c in tgm.COMPETITORS:
                    assert _same(tgm.COMPETITORS[c](R, C, bits),
                                 jgm.COMPETITORS[c](R, C, bits))
        for j, t in _pairs()[:2]:
            for persistent in (True, False):
                for c in tgm.COMPETITORS:
                    assert tgm.speedup_grid(bits, persistent, t, c) == \
                        jgm.speedup_grid(bits, persistent, j, c)
    for j, t in _pairs()[:2]:
        assert tgm.max_speedups(t) == jgm.max_speedups(j)


@pytest.mark.parametrize("model,bits,variant", [
    ("alexnet", 8, "BRAMAC-1DA"), ("alexnet", 2, None)])
def test_dla_explore_matches_jax(model, bits, variant):
    """One design-space exploration each side, and the resource and cycle
    models it is built from."""
    tv = tefsm.VARIANTS[variant] if variant else None
    jv = jefsm.VARIANTS[variant] if variant else None
    tcfg, tstats = tdla.explore(model, bits, tv)
    jcfg, jstats = jdla.explore(model, bits, jv)
    assert _same(tcfg, jcfg) and tstats == jstats
    layers_t, layers_j = twl.MODELS[model], jwl.MODELS[model]
    assert tdla.storage_brams(4, 16, bits, layers_t) == \
        jdla.storage_brams(4, 16, bits, layers_j)
    for q, c, k in ((2, 16, 96), (3, 12, 24), (1, 24, 140), (0, 8, 8)):
        assert tdla.dsp_count(q, c, k, bits) == jdla.dsp_count(q, c, k, bits)
        for jvar, tvar in _pairs()[:2]:
            assert tdla.bramac_blocks(q, c, k, bits, tvar) == \
                jdla.bramac_blocks(q, c, k, bits, jvar)
            assert tdla.max_qvec2(tvar, bits) == jdla.max_qvec2(jvar, bits)
            tc = tdla.Config(q, 1, c, k, bits, tvar)
            jc = jdla.Config(q, 1, c, k, bits, jvar)
            assert tc.resources(layers_t) == jc.resources(layers_j)
            assert tc.area(layers_t) == jc.area(layers_j)
            assert tdla.model_cycles(tc, layers_t) == \
                jdla.model_cycles(jc, layers_j)
