"""Arria-10 resource/throughput/utilization models (Table I/II, Fig 7/9/10).

Copy of `repro.core.arch_models` for the PyTorch port, which imports nothing of
the JAX package: every constant and expression as there, in the same
order, so each derived number matches to the last digit.

All constants are from the paper unless marked DERIVED; derivations are
documented inline.  This mirrors the paper's own methodology: Figs 9–13 are
analytical-model results, not silicon measurements, so the reproduction is
exact up to the constants the paper does not tabulate.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.efsm import Variant

# ---------------------------------------------------------------------------
# Baseline FPGA: Arria-10 GX900, fastest speed grade (Table I)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arria10:
    logic_blocks: int = 33_920        # LABs (Table I)
    dsps: int = 1_518                 # Table I
    brams: int = 2_423                # M20K count of GX900 (Intel tables).
    #   Table I's BRAM row reads "33920" — a PDF extraction artifact
    #   (duplicated from the LB row); the GX900 datasheet value is 2423,
    #   consistent with the 20.1% area ratio.
    lb_area_ratio: float = 0.704
    dsp_area_ratio: float = 0.095
    bram_area_ratio: float = 0.201

    # Frequencies (§VI-A): Quartus-generated
    m20k_fmax_mhz: float = 645.0      # simple dual-port M20K
    dsp_fmax_mhz: float = 549.0       # m18x18_sumof2 mode

    @property
    def dsp_rel_area(self) -> float:
        """DSP area in units of one M20K (from the Table I area ratios)."""
        return (self.dsp_area_ratio / self.dsps) / \
               (self.bram_area_ratio / self.brams)


ARRIA10 = Arria10()

# DSP packing (§VI-A, [36]): each of the two 18×19 multipliers implements
# one 8-bit, two 4-bit, or four 2-bit MACs.
DSP_MACS_PER_MULT = {2: 4, 4: 2, 8: 1}

# DERIVED: soft-logic (LB) MAC throughput in MAC/s for the whole device.
# The paper synthesizes one MAC/precision in Quartus and scales to all LBs
# ("optimistically assuming that all LBs can be used at the same Fmax") but
# does not tabulate the raw numbers.  We invert them from the paper's
# reported total-boost ratios, which over-determine the three unknowns:
#   2-bit: (LB+6.67T+22.72T)/(LB+6.67T)=2.6  → LB = 7.53 TMAC/s
#          cross-check 1DA: (14.2T+16.15T)/14.2T = 2.14 ≈ 2.1 ✓
#   4-bit: …=2.3 → LB = 2.92 TMAC/s; 1DA check: 1.97 ≈ 2.0 ✓
#   8-bit: …=1.9 → LB = 1.20 TMAC/s; 1DA check: 1.70 = 1.7 ✓
LB_TOTAL_MACS_PER_S = {2: 7.53e12, 4: 2.92e12, 8: 1.20e12}


# ---------------------------------------------------------------------------
# Competing architectures (Table II)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitSerialBram:
    """CCB / CoMeFa: bit-serial compute-in-BRAM (160 lanes, transposed)."""
    name: str
    fmax_slowdown: float              # vs baseline M20K (§VI-A)
    block_area_overhead: float        # Table II
    # MAC latency in cycles (unsigned multiply + psum accumulate), Table II:
    mac_latency: tuple[int, int, int] = (16, 42, 113)   # 2/4/8-bit
    lanes: int = 160

    @property
    def fmax_mhz(self) -> float:
        return ARRIA10.m20k_fmax_mhz / self.fmax_slowdown

    def mac_cycles(self, bits: int) -> int:
        return dict(zip((2, 4, 8), self.mac_latency))[bits]

    def macs_per_cycle(self, bits: int) -> float:
        return self.lanes / self.mac_cycles(bits)


CCB = BitSerialBram("CCB", fmax_slowdown=1.6, block_area_overhead=0.168)
COMEFA_D = BitSerialBram("CoMeFa-D", fmax_slowdown=1.25,
                         block_area_overhead=0.254)
COMEFA_A = BitSerialBram("CoMeFa-A", fmax_slowdown=2.5,
                         block_area_overhead=0.081)


@dataclasses.dataclass(frozen=True)
class LowPrecisionDsp:
    """eDSP / PIR-DSP baselines (Table II)."""
    name: str
    macs_per_block: dict  # per precision
    fmax_mhz: float
    block_area_overhead: float


EDSP = LowPrecisionDsp("eDSP", {2: 8, 4: 8, 8: 4}, 549.0, 0.12)
PIR_DSP = LowPrecisionDsp("PIR-DSP", {2: 24, 4: 12, 8: 6}, 549.0 / 1.3, 0.28)


# ---------------------------------------------------------------------------
# Fig 9: peak MAC throughput
# ---------------------------------------------------------------------------

def dsp_throughput(bits: int, fpga: Arria10 = ARRIA10) -> float:
    """Baseline DSP MAC/s: 2 multipliers per DSP × packing × Fmax."""
    return fpga.dsps * 2 * DSP_MACS_PER_MULT[bits] * fpga.dsp_fmax_mhz * 1e6


def lb_throughput(bits: int) -> float:
    return LB_TOTAL_MACS_PER_S[bits]


def bram_throughput(arch, bits: int, fpga: Arria10 = ARRIA10) -> float:
    """MAC/s contributed by compute-capable BRAM blocks."""
    if isinstance(arch, Variant):                 # BRAMAC
        return fpga.brams * arch.macs_per_cycle(bits) * arch.fmax_mhz * 1e6
    if isinstance(arch, BitSerialBram):           # CCB / CoMeFa
        return fpga.brams * arch.macs_per_cycle(bits) * arch.fmax_mhz * 1e6
    return 0.0


def peak_throughput(bits: int, bram_arch=None, dsp_arch=None,
                    fpga: Arria10 = ARRIA10) -> dict:
    """Fig 9: total peak MAC throughput breakdown for one configuration."""
    if dsp_arch is None:
        dsp = dsp_throughput(bits, fpga)
    else:
        dsp = fpga.dsps * dsp_arch.macs_per_block[bits] * dsp_arch.fmax_mhz * 1e6
    lb = lb_throughput(bits)
    bram = bram_throughput(bram_arch, bits, fpga) if bram_arch else 0.0
    return {"lb": lb, "dsp": dsp, "bram": bram, "total": lb + dsp + bram}


def throughput_boost(bits: int, bram_arch, fpga: Arria10 = ARRIA10) -> float:
    """Enhanced-FPGA peak throughput / baseline peak throughput."""
    base = peak_throughput(bits, None, None, fpga)["total"]
    enh = peak_throughput(bits, bram_arch, None, fpga)["total"]
    return enh / base


# ---------------------------------------------------------------------------
# Fig 10: BRAM utilization efficiency for DNN model storage
# ---------------------------------------------------------------------------

M20K_ROWS = 128   # physical rows of the main array


def bramac_utilization(p: int) -> float:
    """BRAMAC stores weights densely; odd precisions sign-extend to 4/8-bit."""
    stored = 2 if p <= 2 else 4 if p <= 4 else 8
    return p / stored


def comefa_utilization(p: int) -> float:
    """CoMeFa (one-operand-outside): per compute column, scratch rows hold
    the 2p-bit product and (2p+4)-bit partial sum; the rest store weights."""
    overhead = 2 * p + (2 * p + 4)
    return max(0, M20K_ROWS - overhead) / M20K_ROWS


def ccb_utilization(p: int, pack: int) -> float:
    """CCB additionally keeps `pack` input-element copies resident
    (pack-k computes k sequential MACs before pausing for input writes)."""
    overhead = pack * p + 2 * p + (2 * p + 4)
    return max(0, M20K_ROWS - overhead) / M20K_ROWS


def utilization_table(precisions=range(2, 9)) -> dict:
    return {
        "BRAMAC": [bramac_utilization(p) for p in precisions],
        "CCB-Pack-2": [ccb_utilization(p, 2) for p in precisions],
        "CCB-Pack-4": [ccb_utilization(p, 4) for p in precisions],
        "CoMeFa": [comefa_utilization(p) for p in precisions],
    }


def utilization_advantage() -> dict:
    """Average (over 2–8 bit) BRAMAC advantage; paper: 1.3× CCB, 1.1× CoMeFa."""
    t = utilization_table()
    avg = {k: sum(v) / len(v) for k, v in t.items()}
    ccb = (avg["CCB-Pack-2"] + avg["CCB-Pack-4"]) / 2
    return {"vs_ccb": avg["BRAMAC"] / ccb,
            "vs_comefa": avg["BRAMAC"] / avg["CoMeFa"],
            "averages": avg}


# ---------------------------------------------------------------------------
# Fig 7: adder design study (COFFE-derived constants from the paper)
# ---------------------------------------------------------------------------

ADDERS = {
    # name: (delay @32-bit [ps], area [um^2, ~equal per Fig 7b], power [uW])
    "RCA": {"delay_32b_ps": 393.6, "power_uw": 11.3},
    "CBA": {"delay_32b_ps": 139.6, "power_uw": 50.2},
    "CLA": {"delay_32b_ps": 157.6, "power_uw": 17.6},
}


def adder_delay_ps(kind: str, bits: int) -> float:
    """Scaling model: RCA delay ∝ n (ripple); CBA/CLA ∝ n/4 stages of a
    4-bit carry chain / lookahead group, anchored at the paper's 32-bit
    values."""
    anchor = ADDERS[kind]["delay_32b_ps"]
    if kind == "RCA":
        return anchor * bits / 32.0
    stages = math.ceil(bits / 4)
    return anchor * stages / 8.0


DUMMY_ARRAY_AREA_UM2 = 975.6        # §V-C
DUMMY_ARRAY_AREA_OVERHEAD = 0.169   # 16.9% of an M20K per dummy array
EFSM_AREA_UM2 = {"BRAMAC-2SA": 137.0, "BRAMAC-1DA": 81.0}  # 22nm-scaled
