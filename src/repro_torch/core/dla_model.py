"""DLA / DLA-BRAMAC cycle-accurate model + design-space exploration (§VI-D).

Copy of `repro.core.dla_model` for the PyTorch port, which imports nothing of
the JAX package: every constant and expression as there, in the same
order, so each derived number matches to the last digit.

DLA (Aydonat et al. [9]) is a 1-D systolic CNN accelerator parameterized by
(Qvec, Cvec, Kvec) — parallelism in output-width, input-depth, and
output-depth.  DLA-BRAMAC adds Qvec2 extra output columns computed by the
BRAMAC-enhanced filter cache (Fig 12c): the stream buffer broadcasts input
features to both the PE array and the filter-cache BRAMACs, which compute
`Qvec2` additional outputs along the Q dimension.

Cycle model (per conv layer, output-stationary sweep):
    cycles = H_out · ceil(W_out / Qvec_total) · ceil(C / Cvec)
                   · ceil(K / Kvec) · (R · S)
BRAMAC's weight-copy pipeline is hidden by the eFSM except for the first
MAC2 of each layer (+2 cycles, §VI-D); the accumulator readout is amortized
across the dot product (included via an efficiency factor on the BRAMAC
columns).

Resource model:
  * DSPs  = Qvec1 · Cvec · Kvec · 1.5 / pack(p)   [DERIVED: this exactly
    reproduces every DSP count in Table III, e.g. 8-bit AlexNet (3,12,24) →
    864·1.5 = 1296 ✓; the 1.5 is DLA's PE-array overhead for Winograd/
    reduction logic, folded into an effective DSPs-per-MAC factor]
  * BRAMAC compute blocks: enough blocks that the filter cache sustains
    Qvec2·Cvec·Kvec MACs/cycle at the variant's MACs-per-cycle rate, with
    each block's weight lanes matched to the (Cvec · R · S) dot products.
  * Storage BRAMs: stream buffer (double-buffered input/output tiles) +
    filter cache (weights for Kvec output channels, double-buffered).

The DSE sweeps (Qvec or Qvec1+Qvec2, Cvec, Kvec) under the GX900 resource
budget (1518 DSPs / 2423 BRAMs) maximizing the paper's target
perf · (perf/area), where area is the utilized DSP-plus-BRAM area with
BRAMAC's block overhead applied (Fig 13b).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from repro_torch.core.arch_models import ARRIA10, DSP_MACS_PER_MULT
from repro_torch.core.efsm import BRAMAC_1DA, BRAMAC_2SA, Variant
from repro_torch.core.workloads import MODELS, ConvLayer

M20K_BITS = 20 * 1024
DSP_PER_MAC_FACTOR = 1.5      # DERIVED from Table III (see module docstring)


# ---------------------------------------------------------------------------
# Resource model
# ---------------------------------------------------------------------------

def dsp_count(qvec1: int, cvec: int, kvec: int, bits: int) -> int:
    if qvec1 == 0:
        return 0
    macs = qvec1 * cvec * kvec
    return math.ceil(macs * DSP_PER_MAC_FACTOR / DSP_MACS_PER_MULT[bits])


def storage_brams(cvec: int, kvec: int, bits: int, layers) -> int:
    """Stream buffer + filter cache storage blocks.

    DLA keeps feature maps on chip (stream buffer holds the in/out pair of
    the largest conv layer) and caches the weights of the largest conv layer
    (FC weights are streamed from DRAM).  This reproduces the magnitude of
    Table III's baseline BRAM counts (e.g. ResNet-34 8-bit ≈ 1.4k blocks).
    """
    convs = [l for l in layers if (l.h_out, l.w_out) != (1, 1)]
    max_w = max(l.weights for l in convs) * bits
    max_fmap = max((l.h_out * l.w_out * l.k) for l in convs) * bits * 2
    return math.ceil(max_w / M20K_BITS) + math.ceil(max_fmap / M20K_BITS)


def bramac_blocks(qvec2: int, cvec: int, kvec: int, bits: int,
                  variant: Variant) -> int:
    """Compute blocks so the filter cache sustains Qvec2·Cvec·Kvec MACs/cyc."""
    if qvec2 == 0:
        return 0
    need = qvec2 * cvec * kvec                     # MACs per cycle
    rate = variant.macs_per_cycle(bits)            # per block
    return math.ceil(need / rate)


@dataclasses.dataclass(frozen=True)
class Config:
    qvec1: int        # output columns on the DSP PE array
    qvec2: int        # output columns on BRAMAC (0 for baseline DLA)
    cvec: int
    kvec: int
    bits: int
    variant: Variant | None = None

    @property
    def qvec(self) -> int:
        return self.qvec1 + self.qvec2

    def resources(self, layers) -> tuple[int, int]:
        dsps = dsp_count(self.qvec1, self.cvec, self.kvec, self.bits)
        brams = storage_brams(self.cvec, self.kvec, self.bits, layers)
        if self.qvec2:
            brams += bramac_blocks(self.qvec2, self.cvec, self.kvec,
                                   self.bits, self.variant)
        return dsps, brams

    def area(self, layers) -> float:
        """Utilized DSP-plus-BRAM area in units of one baseline M20K."""
        dsps, brams = self.resources(layers)
        bram_area = 1.0
        if self.qvec2:
            bram_area = 1.0 + self.variant.block_area_overhead
        return dsps * ARRIA10.dsp_rel_area + brams * bram_area


# ---------------------------------------------------------------------------
# Cycle model
# ---------------------------------------------------------------------------

def layer_cycles(cfg: Config, layer: ConvLayer) -> int:
    c = layer.h_out * math.ceil(layer.w_out / cfg.qvec) \
        * math.ceil(layer.c / cfg.cvec) * math.ceil(layer.k / cfg.kvec) \
        * (layer.r * layer.s)
    if cfg.qvec2:
        c += 2        # first MAC2 weight copy of the layer (§VI-D)
    return c


def model_cycles(cfg: Config, layers) -> int:
    return sum(layer_cycles(cfg, l) for l in layers)


# ---------------------------------------------------------------------------
# Design-space exploration
# ---------------------------------------------------------------------------

_QVECS = tuple(range(1, 33))
_CVECS = (1, 2, 3, 4, 6, 8, 12, 16, 22, 24, 32, 48, 64)
_KVECS = tuple(range(8, 161, 2))


def _candidate_perf(cfg: Config, layers) -> tuple[float, float]:
    cycles = model_cycles(cfg, layers)
    perf = 1.0 / cycles
    return perf, perf * perf / cfg.area(layers)


def max_qvec2(variant: Variant, bits: int) -> int:
    """Structural Qvec2 limit (matches every Table III config).

    2SA's two dummy arrays copy the same weights but take different input
    streams (§IV-A input sharing) → two extra output columns.  1DA has one
    dummy array → one column; at 2-bit its lanes are cheap enough that the
    paper's configs replicate weights across a second block group → two.
    """
    if variant.dummy_arrays == 2:
        return 2
    return 2 if bits == 2 else 1


def explore(model: str, bits: int, variant: Variant | None = None,
            dsp_budget: int = ARRIA10.dsps,
            bram_budget: int = ARRIA10.brams) -> tuple[Config, dict]:
    """DSE maximizing perf·(perf/area) under the resource budget."""
    layers = MODELS[model]
    best, best_score = None, -1.0
    qvec2s = (0,) if variant is None else \
        tuple(range(1, max_qvec2(variant, bits) + 1))
    for cvec, kvec in itertools.product(_CVECS, _KVECS):
        for q1 in _QVECS:
            for q2 in qvec2s:
                if q2 and variant is None:
                    continue
                cfg = Config(q1, q2, cvec, kvec, bits, variant)
                dsps, brams = cfg.resources(layers)
                if dsps > dsp_budget or brams > bram_budget:
                    continue
                perf, score = _candidate_perf(cfg, layers)
                if score > best_score:
                    best, best_score = cfg, score
    dsps, brams = best.resources(layers)
    stats = {"cycles": model_cycles(best, layers), "dsps": dsps,
             "brams": brams, "area": best.area(layers)}
    return best, stats


def case_study(models=("alexnet", "resnet34"), precisions=(2, 4, 8)) -> dict:
    """Fig 13: speedup and area of DLA-BRAMAC vs DLA per (model, precision)."""
    out = {}
    for model in models:
        for bits in precisions:
            base_cfg, base = explore(model, bits, None)
            row = {"dla": (base_cfg, base)}
            for variant in (BRAMAC_2SA, BRAMAC_1DA):
                cfg, stats = explore(model, bits, variant)
                stats["speedup"] = base["cycles"] / stats["cycles"]
                stats["rel_area"] = stats["area"] / base["area"]
                stats["perf_per_area"] = stats["speedup"] / stats["rel_area"]
                row[variant.name] = (cfg, stats)
            out[(model, bits)] = row
    return out


def average_speedups(results: dict | None = None) -> dict:
    """Headline numbers (paper: AlexNet 2.05×/1.7×, ResNet-34 1.33×/1.52×)."""
    results = results or case_study()
    avg = {}
    for model in ("alexnet", "resnet34"):
        for vname in ("BRAMAC-2SA", "BRAMAC-1DA"):
            sp = [results[(model, b)][vname][1]["speedup"] for b in (2, 4, 8)]
            ar = [results[(model, b)][vname][1]["rel_area"] for b in (2, 4, 8)]
            avg[(model, vname)] = {"speedup": sum(sp) / 3,
                                   "rel_area": sum(ar) / 3}
    return avg
