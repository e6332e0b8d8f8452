"""The BRAMAC paper path: the evaluation figures from the analytical models,
Algorithm 1 on the device, and the Fig 11 GEMVs through the dummy array.

    PYTHONPATH=src python -m repro_torch.launch.paper [--device cuda|cpu] \
        [--seed 0]

The port's counterpart of `examples/gemv_paper_repro.py` and of
`examples/quickstart.py`'s `demo_mac2`.  It prints Table II, the Fig 9
throughput table, the Fig 10 utilization curves, the Fig 11 speedup heatmap
(2-bit persistent) and the Fig 13 DLA summary in the example's words; then
the MAC2 demo, computed with `core.mac2` on the device; then it runs every
GEMV whose cycles Fig 11 models — each (R, C) of ROW_SIZES x COL_SIZES at
2/4/8 bits, signed, weights and inputs drawn with numpy from `--seed` —
through the dummy-array kernel (`kernels.mac2_kernel`), holds each against
the exact integer product bit for bit, and raises on any difference.

Runs on the card by default; `--device cpu` runs the kernel's plain PyTorch
version, and without a GPU and without `--device cpu` it raises.
`derived_rows` formats the reproduced quantities as the deterministic
`table2_*`/`fig*_*` rows of `benchmarks/baseline.json`.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import arch_models as am
from repro_torch.core import gemv_model as gm
from repro_torch.core import mac2, quant
from repro_torch.core.dla_model import average_speedups, case_study
from repro_torch.core.efsm import BRAMAC_1DA, BRAMAC_2SA
from repro_torch.kernels import ref
from repro_torch.kernels.mac2_kernel import mac2_mvm_kernel
from repro_torch.runtime.serve import resolve_device

# the paper's values, as the benchmark rows quote them
PAPER_BOOSTS = {("2SA", 2): 2.6, ("2SA", 4): 2.3, ("2SA", 8): 1.9,
                ("1DA", 2): 2.1, ("1DA", 4): 2.0, ("1DA", 8): 1.7}
PAPER_GEMV = {("persistent", 2): 3.3, ("persistent", 4): 2.8,
              ("persistent", 8): 2.4, ("nonpersistent", 2): 4.1,
              ("nonpersistent", 4): 3.4, ("nonpersistent", 8): 2.8}
PAPER_DLA = {("alexnet", "BRAMAC-2SA"): 2.05, ("alexnet", "BRAMAC-1DA"): 1.7,
             ("resnet34", "BRAMAC-2SA"): 1.33,
             ("resnet34", "BRAMAC-1DA"): 1.52}


def table2():
    print("=== Table II ===")
    for v in (BRAMAC_2SA, BRAMAC_1DA):
        lat = "/".join(str(v.mac2_latency(b)) for b in (2, 4, 8))
        par = "/".join(str(v.macs_in_parallel(b)) for b in (2, 4, 8))
        print(f"  {v.name}: {par} MACs in parallel, {lat} cycle latency, "
              f"{v.block_area_overhead:.1%} block / "
              f"{v.core_area_overhead:.1%} core area overhead")


def fig9():
    print("=== Fig 9: peak MAC throughput (TMAC/s) ===")
    for bits in (2, 4, 8):
        base = am.peak_throughput(bits)["total"] / 1e12
        row = [f"baseline {base:5.1f}"]
        for arch in (BRAMAC_2SA, BRAMAC_1DA, am.CCB, am.COMEFA_D,
                     am.COMEFA_A):
            tot = am.peak_throughput(bits, arch)["total"] / 1e12
            row.append(f"{arch.name} {tot:5.1f} ({tot / base:.2f}x)")
        print(f"  {bits}-bit: " + " | ".join(row))


def fig10():
    print("=== Fig 10: BRAM utilization efficiency ===")
    t = am.utilization_table()
    ps = list(range(2, 9))
    for name, vals in t.items():
        print(f"  {name:11s}: " +
              " ".join(f"{p}b={v:.2f}" for p, v in zip(ps, vals)))
    adv = am.utilization_advantage()
    print(f"  avg advantage: {adv['vs_ccb']:.2f}x vs CCB (paper 1.3x), "
          f"{adv['vs_comefa']:.2f}x vs CoMeFa (paper 1.1x)")


def fig11():
    print("=== Fig 11: BRAMAC-1DA GEMV speedup over CCB-Pack-4 "
          "(2-bit persistent) ===")
    grid = gm.speedup_grid(2, persistent=True)
    cols = gm.COL_SIZES
    print("      C=" + "".join(f"{c:>7}" for c in cols))
    for r in gm.ROW_SIZES:
        print(f"  R={r:4d} " + "".join(f"{grid[(r, c)]:7.2f}" for c in cols))
    ms = gm.max_speedups()
    print("  up-to: " + ", ".join(
        f"{k[1]}b-{k[0][:7]} {v:.2f}x" for k, v in sorted(ms.items())))


def fig13(results: dict):
    """`results` is `dla_model.case_study()`."""
    print("=== Fig 13: DLA-BRAMAC case study (avg over 2/4/8-bit) ===")
    for (model, vname), row in average_speedups(results).items():
        print(f"  {model:9s} {vname}: {row['speedup']:.2f}x speedup at "
              f"{row['rel_area']:.2f}x DSP+BRAM area")


def demo_mac2(device):
    print("=== Algorithm 1: hybrid bit-serial & bit-parallel MAC2 ===")
    w1, w2, i1, i2 = -3, 7, -5, 2
    p = int(mac2.mac2(torch.tensor(w1, dtype=torch.int32, device=device),
                      torch.tensor(w2, dtype=torch.int32, device=device),
                      i1, i2, bits=4))
    print(f"  W1*I1 + W2*I2 = {w1}*{i1} + {w2}*{i2} = {p} "
          f"(oracle {w1 * i1 + w2 * i2})")

    rng = np.random.default_rng(0)
    w = rng.integers(-8, 8, (8, 6)).astype(np.int8)      # Fig 2's 8x6 matrix
    x = rng.integers(-8, 8, (6,)).astype(np.int8)
    y = mac2.mac2_mvm(torch.from_numpy(w).to(device),
                      torch.from_numpy(x).to(device), bits=4)
    print(f"  Fig 2 MVM via chained MAC2s: max|err| = "
          f"{np.abs(y.cpu().numpy() - w.astype(np.int32) @ x).max()}")


def fig11_gemvs(device, seed: int = 0) -> tuple[int, int]:
    """Every Fig 11 GEMV through `mac2_mvm_kernel`, bit-exact against the
    integer oracle; returns (MVMs run, max |error|)."""
    print("=== Fig 11 GEMVs through the dummy-array MAC2 kernel ===")
    rng = np.random.default_rng(seed)
    n, worst = 0, 0
    for bits in (2, 4, 8):
        lo, hi = quant.qrange(bits)
        for R in gm.ROW_SIZES:
            for C in gm.COL_SIZES:
                w = torch.from_numpy(
                    rng.integers(lo, hi + 1, (R, C), dtype=np.int8)).to(device)
                x = torch.from_numpy(
                    rng.integers(lo, hi + 1, (C,), dtype=np.int8)).to(device)
                got = mac2_mvm_kernel(w, x, bits=bits)
                want = ref.mac2_mvm_ref(w, x)
                worst = max(worst, int((got.long() - want.long()).abs().max()))
                if not torch.equal(got, want):
                    raise RuntimeError(f"mac2_mvm_kernel != w @ x at R={R} "
                                       f"C={C} bits={bits}")
                n += 1
    print(f"  {n} MVMs (R in {gm.ROW_SIZES} x C in {gm.COL_SIZES} x "
          f"2/4/8-bit, signed, seed {seed}) bit-exact vs w @ x: "
          f"max|err| = {worst}")
    return n, worst


def derived_rows(results: dict) -> dict[str, str]:
    """The deterministic `table2_*`/`fig*_*` rows of `benchmarks/baseline.json`
    ({name: derived}), formatted as `benchmarks/run.py` formats them;
    `results` is `dla_model.case_study()`."""
    rows = {}
    lat = {v: "/".join(str(v.mac2_latency(b)) for b in (2, 4, 8))
           for v in (BRAMAC_2SA, BRAMAC_1DA)}
    rows["table2_latency_2sa"] = lat[BRAMAC_2SA] + " (paper 5/7/11)"
    rows["table2_latency_1da"] = lat[BRAMAC_1DA] + " (paper 3/4/6)"
    rows["table2_parallel_2sa"] = "/".join(
        str(BRAMAC_2SA.macs_in_parallel(b)) for b in (2, 4, 8)) \
        + " (paper 80/40/20)"
    d = {k: am.adder_delay_ps(k, 32) for k in ("RCA", "CBA", "CLA")}
    rows["fig7_rca_over_cba"] = f"{d['RCA'] / d['CBA']:.2f}x (paper 2.8x)"
    rows["fig7_rca_over_cla"] = f"{d['RCA'] / d['CLA']:.2f}x (paper 2.5x)"
    for variant, tag in ((BRAMAC_2SA, "2SA"), (BRAMAC_1DA, "1DA")):
        for bits in (2, 4, 8):
            boost = am.throughput_boost(bits, variant)
            rows[f"fig9_boost_{tag}_{bits}bit"] = \
                f"{boost:.2f}x (paper {PAPER_BOOSTS[(tag, bits)]}x)"
    adv = am.utilization_advantage()
    rows["fig10_vs_ccb"] = f"{adv['vs_ccb']:.2f}x (paper 1.3x)"
    rows["fig10_vs_comefa"] = f"{adv['vs_comefa']:.2f}x (paper 1.1x)"
    for key, val in gm.max_speedups().items():
        rows[f"fig11_{key[0]}_{key[1]}bit"] = \
            f"{val:.2f}x (paper {PAPER_GEMV[key]}x)"
    for (model, vname), row in average_speedups(results).items():
        rows[f"fig13_{model}_{vname}"] = (
            f"{row['speedup']:.2f}x speedup / {row['rel_area']:.2f}x area "
            f"(paper {PAPER_DLA[(model, vname)]}x)")
    return rows


def run(device, seed: int = 0) -> dict:
    """Print every section; return the derived rows and the GEMV check."""
    table2()
    fig9()
    fig10()
    fig11()
    results = case_study()
    fig13(results)
    demo_mac2(device)
    n, worst = fig11_gemvs(device, seed)
    return {"derived": derived_rows(results), "gemvs": n, "max_abs_err": worst}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the Fig 11 GEMV weights and inputs")
    args = ap.parse_args(argv)
    run(resolve_device(args.device), args.seed)


if __name__ == "__main__":
    main()
