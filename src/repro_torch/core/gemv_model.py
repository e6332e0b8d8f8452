"""Analytical GEMV cycle model — BRAMAC-1DA/2SA vs CCB / CoMeFa (Fig 11).

Copy of `repro.core.gemv_model` for the PyTorch port, which imports nothing of
the JAX package: every constant and expression as there, in the same
order, so each derived number matches to the last digit.

The paper benchmarks GEMV `y[R] = W[R,C] @ x[C]` on a SINGLE BRAM block
("performance normalized to BRAM utilization"), counting cycles with a
deterministic analytical model, persistent (weights resident) and
non-persistent (weight loading included).

**BRAMAC mapping** (Fig 2): dummy-array lanes hold a tile of `R_tile`
outputs; each MAC2 consumes one column *pair*, so a dot product takes
`ceil(C/2)` MAC2 issues of `mac2_latency` cycles each.  The accumulator row
must be drained (readout_busy cycles) every `max_dot_product_macs` MACs and
once at the end of each tile's dot product.

**CCB/CoMeFa mapping** (derived from the paper's §VI-C discussion): the dot
product is parallelized *across* the 160 lanes (transposed layout — element
c of x and column c of W live in lane c%160), one output at a time:
`n_seg = ceil(C/160)` sequential bit-serial MACs per output, then an
in-memory reduction across lanes folds the per-lane partial sums.  A packing
factor k keeps k segments' results resident so only `ceil(n_seg/k)`
reductions are needed — exactly the paper's "column size 480 → 3 sequential
MACs before a slow in-memory reduction / column size 128 → a reduction after
every MAC".  Per-MAC latencies are Table II's 16/42/113 (unsigned — the
paper notes CCB/CoMeFa would be slower still for 2's complement).  The
reduction cost is a log-tree of bit-serial adds; the paper does not tabulate
it, so we use T_red(p) = 6p + 8 cycles (DERIVED, calibrated to the paper's
"up to 3.3×/2.8×/2.4×" persistent speedups; see EXPERIMENTS.md §Fig11).

**Non-persistent**: CCB/CoMeFa cannot overlap loading with compute (their
CIM instructions occupy the write port → "this prevents tiling"), so load
cycles add serially: `R*C*p/40` port-write cycles (+ transposition handled
by the swizzle hardware at line rate).  BRAMAC overlaps loading with compute
via the eFSM; only the main-BRAM busy cycles (weight-read issues + accumulator
readouts) and any load remainder are exposed:
`max(compute, load + busy)`.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.arch_models import CCB, COMEFA_D, BitSerialBram
from repro_torch.core.efsm import BRAMAC_1DA, PORT_BITS, Variant

T_RED_COEF = (6, 8)     # T_red(p) = 6p + 8 (calibrated, see module docstring)


def reduction_cycles(bits: int) -> int:
    a, b = T_RED_COEF
    return a * bits + b


# ---------------------------------------------------------------------------
# BRAMAC
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemvCycles:
    compute: int          # cycles the CIM engine is computing
    load: int             # weight-loading port cycles (non-persistent only)
    port_busy: int        # main-BRAM busy cycles (reads for copy + readouts)
    total_persistent: int
    total_nonpersistent: int


def bramac_gemv(variant: Variant, R: int, C: int, bits: int,
                signed: bool = True) -> GemvCycles:
    lanes = variant.mac2_lanes(bits)          # output rows per tile
    tiles = math.ceil(R / lanes)
    n_mac2 = math.ceil(C / 2)
    lat = variant.mac2_latency(bits, signed)
    # accumulator drains: every max_dot MACs and once at end of dot product
    max_dot = variant.max_dot_product_macs(bits)
    drains = math.ceil(C / max_dot)
    readout = variant.readout_busy_cycles()
    per_tile_compute = n_mac2 * lat + drains * readout
    compute = tiles * per_tile_compute + 2    # +2: initial un-pipelined copy
    # port busy: weight-read issues + readouts (these block tile loading)
    busy = tiles * (n_mac2 * variant.port_busy_per_mac2 + drains * readout)
    load = math.ceil(R * C * bits / PORT_BITS)
    nonpersistent = max(compute, load + busy)
    return GemvCycles(compute, load, busy, compute, nonpersistent)


# ---------------------------------------------------------------------------
# CCB / CoMeFa
# ---------------------------------------------------------------------------

def bitserial_gemv(arch: BitSerialBram, R: int, C: int, bits: int,
                   pack: int = 1, streams_input: bool = False) -> GemvCycles:
    """pack: CCB packing factor (1/2/4); CoMeFa streams the input operand
    (streams_input=True) instead of writing input copies."""
    n_seg = math.ceil(C / arch.lanes)
    k_eff = min(pack, n_seg) if pack > 1 else 1
    per_out = n_seg * arch.mac_cycles(bits) \
        + math.ceil(n_seg / k_eff) * reduction_cycles(bits)
    compute = R * per_out
    input_writes = 0 if streams_input else bits * n_seg
    compute += input_writes
    load = math.ceil(R * C * bits / PORT_BITS)
    # CIM occupies the ports: loading cannot overlap compute (no tiling)
    return GemvCycles(compute, load, compute, compute, compute + load)


# ---------------------------------------------------------------------------
# Fig 11 speedup heatmaps
# ---------------------------------------------------------------------------

ROW_SIZES = (64, 96, 128, 160, 256, 320, 512)       # matrix rows R
COL_SIZES = (128, 160, 256, 320, 480)               # matrix cols C

COMPETITORS = {
    "CCB-Pack-4": lambda R, C, b: bitserial_gemv(CCB, R, C, b, pack=4),
    "CCB-Pack-2": lambda R, C, b: bitserial_gemv(CCB, R, C, b, pack=2),
    "CoMeFa": lambda R, C, b: bitserial_gemv(COMEFA_D, R, C, b,
                                             streams_input=True),
}


def speedup_grid(bits: int, persistent: bool, variant: Variant = BRAMAC_1DA,
                 competitor: str = "CCB-Pack-4"):
    """Fig 11: speedup of BRAMAC (cycles) over a competitor, per (R, C)."""
    comp = COMPETITORS[competitor]
    grid = {}
    for R in ROW_SIZES:
        for C in COL_SIZES:
            ours = bramac_gemv(variant, R, C, bits)
            theirs = comp(R, C, bits)
            key = "total_persistent" if persistent else "total_nonpersistent"
            grid[(R, C)] = getattr(theirs, key) / getattr(ours, key)
    return grid


def max_speedups(variant: Variant = BRAMAC_1DA) -> dict:
    """Headline 'up to' numbers (paper: 3.3/2.8/2.4 persistent,
    4.1/3.4/2.8 non-persistent for 2/4/8-bit, vs the slower of CCB/CoMeFa)."""
    out = {}
    for persistent in (True, False):
        for bits in (2, 4, 8):
            best = max(
                max(speedup_grid(bits, persistent, variant, c).values())
                for c in COMPETITORS)
            tag = "persistent" if persistent else "nonpersistent"
            out[(tag, bits)] = best
    return out
