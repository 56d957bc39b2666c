"""Roofline terms of one step and the collective bytes behind them (the
reference's `roofline/analysis.py`, for the port's card).

    compute term    = FLOPs a chip / peak FLOP/s
    memory term     = HBM bytes a chip / HBM bytes/s
    collective term = collective bytes a chip / link bytes/s

The reference parses these from XLA's compiled HLO text: its program is
the per-device program of GSPMD, so it sums the operand bytes of every
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute.
The port has no compiled program: one controller issues every shard's
ops, and the collectives between shards are explicit functions
(`distributed.sharding`: `all_sum`, `concat`, `split`, and with them
`strip_gather` / `strip_scatter`; the data axis's gradient reduction,
ZeRO-1's gather, the int8 error-feedback reduction). `count_collectives`
counts each one's operand bytes a device while a step runs, which is what
the reference reads off its HLO; outside the block nothing is counted.
`collective_costs` turns the count into the reference's record.

The constants are one NVIDIA H100 80GB HBM3 (SXM) at 700 W, the figures
`roofline/costmodel.py` uses: 989e12 dense bf16 FLOP/s, 3.35e12 HBM
bytes/s, and 450e9 bytes/s a direction over NVLink 4 (900 GB/s a card in
both directions together; NVIDIA's H100 data sheet). No TPU constant is
used.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed.sharding import (CollectiveCounter,  # noqa: F401
                                              count_collectives)
from repro_torch.roofline.costmodel import HBM_BW, PEAK_FLOPS

# NVLink 4 on an H100 SXM: 900 GB/s a card, 450 GB/s each way
LINK_BW = 450e9

# the reference's collective kinds, and the port's handing of a tensor
# held on one device to the shards (`split`; no SPMD counterpart)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "scatter")


def collective_costs(counter: CollectiveCounter) -> dict[str, float]:
    """A count's operand bytes a device by kind and their ``total`` (the
    reference's `collective_bytes_from_hlo` record)."""
    out = {k: float(v) for k, v in counter.by_kind.items()}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0    # analytic 6·N·D (or 6·N_active·D)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        if self.flops == 0:
            return 0.0
        return (self.model_flops / self.chips) / self.flops

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline step time (MFU-like)."""
        if self.step_time_s == 0:
            return 0.0
        return (self.model_flops / self.chips / PEAK_FLOPS) \
            / self.step_time_s

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "chips": self.chips,
            "model_flops_global": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(flops, bytes_accessed, collective_bytes, chips,
                   model_flops=0.0) -> RooflineTerms:
    return RooflineTerms(flops, bytes_accessed, collective_bytes, chips,
                         model_flops)
