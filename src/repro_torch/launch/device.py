"""The card's roofline constants: the counterpart of the reference's v5e
constants (`repro.launch.mesh`: PEAK_FLOPS_BF16, HBM_BW, ICI_BW).

Data-sheet dense peaks of the card this port runs on, keyed by the name
`nvidia-smi` and `torch.cuda.get_device_name` print for it (NVIDIA's H100
SXM data sheet, dense rates without sparsity, at its 700 W power limit; a
card set below that limit runs slower under load, so a measurement names
the limit beside it).  The reference's ICI rate has no counterpart: ranks
that share one card collect over gloo through the host, which has no
data-sheet rate, so the dry run gives no collective time.

    card()         -> the present card's Card (its memory from
                      `torch.cuda.get_device_properties`), else the H100's
                      data sheet
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Card:
    name: str
    power_limit_w: float
    bf16_flops_per_s: float      # bf16 / fp16 tensor cores
    int8_ops_per_s: float        # int8 tensor cores
    fp32_flops_per_s: float      # float32 outside the tensor cores
    hbm_bytes_per_s: float
    memory_bytes: int

    def peak(self, dtype_class: str) -> float:
        """The peak rate of a matmul class ("bf16", "int", "f32")."""
        return {"bf16": self.bf16_flops_per_s, "int": self.int8_ops_per_s,
                "f32": self.fp32_flops_per_s}[dtype_class]


H100 = Card(name="NVIDIA H100 80GB HBM3", power_limit_w=700.0,
            bf16_flops_per_s=989e12, int8_ops_per_s=1979e12,
            fp32_flops_per_s=67e12, hbm_bytes_per_s=3.35e12,
            memory_bytes=80 * 10**9)


def card() -> Card:
    """The card present (its data-sheet peaks by name, its memory as the
    driver reports it), or the H100's data sheet when there is none.
    Another card raises: its peaks are not known here."""
    if not torch.cuda.is_available():
        return H100
    name = torch.cuda.get_device_name(0)
    if name != H100.name:
        raise KeyError(f"no data-sheet peaks for {name!r} (known: "
                       f"{H100.name!r})")
    return dataclasses.replace(
        H100, memory_bytes=torch.cuda.get_device_properties(0).total_memory)
