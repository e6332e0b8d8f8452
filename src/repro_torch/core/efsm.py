"""eFSM cycle model — MAC2 latency, port-busy cycles, pipelining (Fig 4/5).

Copy of `repro.core.efsm` for the PyTorch port, which imports nothing of
the JAX package: every constant and expression as there, in the same
order, so each derived number matches to the last digit.

Derivation (verified against the paper's reported numbers):

BRAMAC-2SA, n-bit signed MAC2 (Fig 4): 2 copy cycles (W1, W2 via the two
ports) + 1 cycle (W1+W2, P init) + 1 cycle (MSB invert) + n add/shift cycles
+ 1 accumulate cycle = n + 5 total.  The eFSM overlaps the next MAC2's
2 copy cycles with the last 2 cycles of the current one (Fig 5a), so the
pipelined issue interval is  **n + 3**  → 5 / 7 / 11 cycles for 2/4/8-bit ✓.
Unsigned inputs skip the invert cycle → n + 2.

BRAMAC-1DA (Fig 5b): dummy array double-pumped at 2× clock.  1 main-clock
read + ½ cycle copy + (n + 3) compute half-cycles; the read of the next pair
overlaps compute, so the pipelined interval is  **ceil((n + 4) / 2)**
→ 3 / 4 / 6 cycles for 2/4/8-bit ✓ (unsigned: ceil((n + 3) / 2)).

Main-BRAM port-busy cycles per MAC2: 2 (2SA: one copy cycle per port-pair
per array) / 1 (1DA: both ports issue the two row addresses in one cycle).
Accumulator readout between dot products: 8 (2SA: 2 arrays × 160 b / 40 b)
/ 4 (1DA: 160 b / 40 b) busy cycles.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.quant import SUPPORTED_BITS

ROW_BITS = 160          # dummy array columns == main BRAM physical columns
PORT_BITS = 40          # per-port data width (max-width simple dual port)


def _check(bits):
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"precision must be in {SUPPORTED_BITS}")


@dataclasses.dataclass(frozen=True)
class Variant:
    """One BRAMAC variant's static timing/area parameters."""
    name: str
    dummy_arrays: int            # 2 for 2SA, 1 for 1DA
    double_pumped: bool
    block_area_overhead: float   # vs baseline M20K (Table II)
    core_area_overhead: float
    fmax_mhz: float              # CIM-mode frequency (§V-C / §VI-A)
    port_busy_per_mac2: int      # main-BRAM busy cycles per MAC2 issue

    def mac2_latency(self, bits: int, signed: bool = True) -> int:
        """Pipelined MAC2 issue interval in main-BRAM clock cycles."""
        _check(bits)
        compute = bits + (3 if signed else 2)     # (+sum/init, +invert, n adds)
        if not self.double_pumped:
            return compute                         # copy hidden by pipelining
        return math.ceil((compute + 1) / 2)        # +1 half-cycle copy, 2x clk

    def mac2_lanes(self, bits: int) -> int:
        """MAC2s issued in parallel per instruction (all dummy arrays)."""
        _check(bits)
        return (PORT_BITS // bits) * self.dummy_arrays

    def macs_in_parallel(self, bits: int) -> int:
        """Table II '# of MACs in parallel' (each MAC2 = 2 MACs)."""
        return 2 * self.mac2_lanes(bits)

    def readout_busy_cycles(self) -> int:
        """Main-BRAM busy cycles to drain the accumulator row(s)."""
        return self.dummy_arrays * ROW_BITS // PORT_BITS

    def max_dot_product_macs(self, bits: int) -> int:
        """MACs accumulable before the accumulator row must be drained.

        Paper §IV-C: 16 / 256 / 2048 for 2/4/8-bit.  Accumulator widths are
        8/16/27-bit (Table II footnote; 27-bit matches the DSP accumulator);
        each MAC contributes up to 2^(2·bits) in magnitude →
        capacity = 2^acc_bits / 2^(2·bits).
        """
        _check(bits)
        acc_bits = {2: 8, 4: 16, 8: 27}[bits]
        return 2 ** (acc_bits - 2 * bits)

    def macs_per_cycle(self, bits: int, signed: bool = True) -> float:
        return self.macs_in_parallel(bits) / self.mac2_latency(bits, signed)


BRAMAC_2SA = Variant("BRAMAC-2SA", dummy_arrays=2, double_pumped=False,
                     block_area_overhead=0.338, core_area_overhead=0.068,
                     fmax_mhz=586.0, port_busy_per_mac2=2)
BRAMAC_1DA = Variant("BRAMAC-1DA", dummy_arrays=1, double_pumped=True,
                     block_area_overhead=0.169, core_area_overhead=0.034,
                     fmax_mhz=500.0, port_busy_per_mac2=1)

VARIANTS = {v.name: v for v in (BRAMAC_2SA, BRAMAC_1DA)}
