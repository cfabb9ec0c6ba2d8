"""Collective traffic and roofline terms of one (arch x shape x mesh) cell:
port of ``repro/core/hloanalysis.py``, whose name it keeps so that a reader
finds the counterpart.

There is no HLO here.  The reference parses the compiled, partitioned HLO
text for its collectives (``parse_collectives``); the port runs a rank's
own program (on the meta device in the dry-run), and every collective it
asks for adds to ``runtime.collectives.record``, which
``collective_stats`` reads.  ``CollectiveStats.wire_bytes``,
``collective_wire_bytes``, ``Roofline`` and ``model_flops`` are the
reference's.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM), the datasheet's values:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB of
it, and NVLink 4 at 450 GB/s a direction.  The NVLink rate cannot be
measured on one card, and no run of this repo has measured it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s (H100 SXM datasheet)
HBM_BW = 3.35e12             # bytes/s of HBM3 (H100 SXM datasheet)
HBM_BYTES = 80e9             # bytes of HBM3 (H100 80GB datasheet)
LINK_BW = 450e9              # NVLink 4, bytes/s a direction (datasheet)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    count: int = 0
    result_bytes: int = 0
    operand_bytes: int = 0

    def wire_bytes(self, op: str) -> float:
        """Asymptotic per-device bytes on the wire for ring algorithms."""
        if op == "all-reduce":
            return 2.0 * self.result_bytes
        if op == "all-gather":
            return float(self.result_bytes)       # gathered result size
        if op == "reduce-scatter":
            return float(self.operand_bytes)      # pre-scatter operand size
        return float(self.result_bytes)           # a2a / permute


def collective_stats(record: Dict[str, list]) -> Dict[str, CollectiveStats]:
    """The collectives a rank's program asked for, by kind, from a record
    kind -> [count, result bytes, operand bytes]
    (``runtime.collectives.record``)."""
    return {op: CollectiveStats(*record[op]) for op in COLLECTIVE_OPS
            if op in record and record[op][0]}


def collective_wire_bytes(stats: Dict[str, CollectiveStats]) -> float:
    return sum(v.wire_bytes(op) for op, v in stats.items())


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell.

    All *_s terms are seconds for ONE step on the given mesh; the counts
    are a rank's (one device's share of the program).
    """
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    links: int = 1                # links usable in parallel per device

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / (LINK_BW * self.links)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower bound on step time: terms overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max_term — 1.0 means perfectly compute-bound."""
        return self.compute_s / max(self.step_s, 1e-30)


def model_flops(n_params_active: int, tokens: int, *,
                backward: bool = False) -> float:
    """MODEL_FLOPS = 6·N·D for train (fwd+bwd), 2·N·D for inference."""
    mult = 6.0 if backward else 2.0
    return mult * n_params_active * tokens
