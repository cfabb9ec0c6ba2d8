"""Network-level schedule evaluation — the paper's optimization stack.

Evaluates the four accumulating configurations of Fig 8 on a workload and
reports latency / energy / EDP (normalized to the baseline), plus the
Fig 3 / Fig 5 / Table I quantities the benchmarks print.

Beyond the four hand-coded configs, ``include_auto=True`` appends the
``repro_torch.search`` auto-scheduler's result ("auto" row): every decision
the fixed stack wires in (dual dataflow, pixelwise fusion, IBN fusion)
is instead *searched* over mappings / loop orders / fusion partitions,
and costed under the identical accounting so the rows are comparable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.costmodel import HWSpec, NetworkCost, cost_network
from repro_torch.core.workload import Layer

CONFIG_STACK = (
    ("baseline",      dict(reconfigurable=False, fuse_nonlinear=False,
                           fuse_ibn=False)),
    ("+dual-dataflow", dict(reconfigurable=True, fuse_nonlinear=False,
                            fuse_ibn=False)),
    ("+pixelwise",    dict(reconfigurable=True, fuse_nonlinear=True,
                           fuse_ibn=False)),
    ("+ibn-fusion",   dict(reconfigurable=True, fuse_nonlinear=True,
                           fuse_ibn=True)),
)


@dataclasses.dataclass
class StackResult:
    name: str
    cost: NetworkCost

    @property
    def latency_s(self) -> float:
        return self.cost.latency_s

    @property
    def energy_j(self) -> float:
        return self.cost.energy_j

    @property
    def edp(self) -> float:
        return self.cost.edp


AUTO_CONFIG = "auto"


def auto_result(layers: List[Layer], hw: Optional[HWSpec] = None
                ) -> StackResult:
    """The searched schedule as a stack row (lazy import: core stays
    importable without the search subsystem)."""
    from repro_torch.search import auto_schedule, evaluate_schedule
    hw = hw or HWSpec()
    sched = auto_schedule(layers, hw)
    return StackResult(AUTO_CONFIG, evaluate_schedule(layers, sched, hw))


def evaluate_stack(layers: List[Layer], hw: Optional[HWSpec] = None, *,
                   include_auto: bool = False) -> List[StackResult]:
    hw = hw or HWSpec()
    out = [StackResult(name, cost_network(layers, hw, **kw))
           for name, kw in CONFIG_STACK]
    if include_auto:
        out.append(auto_result(layers, hw))
    return out


def normalized_stack(layers: List[Layer], hw: Optional[HWSpec] = None, *,
                     include_auto: bool = False) -> List[Dict[str, float]]:
    """Fig 8: latency/energy/EDP of each config normalized to baseline."""
    res = evaluate_stack(layers, hw, include_auto=include_auto)
    base = res[0]
    return [{
        "config": r.name,
        "latency": r.latency_s / base.latency_s,
        "energy": r.energy_j / base.energy_j,
        "edp": r.edp / base.edp,
        "fps": 1.0 / r.latency_s,
        "power_mw": r.cost.avg_power_w * 1e3,
        "fps_per_w": r.cost.fps_per_w,
    } for r in res]


def level_breakdown(cost: NetworkCost) -> Dict[str, Dict[str, float]]:
    """Per-memory-level rows of a costed network: bytes through each
    level's port and the energy they cost — the hierarchy-generalized
    successor of the old fixed rf/sram/dram aggregates (level names come
    from the hierarchy, so a 4-level design reports 4 rows)."""
    en = cost.energy_pj()
    tr = cost.traffic_bytes()
    return {name: {"bytes": float(tr[name]), "energy_pj": en[name]}
            for name in cost.hw.hierarchy.names}


def layer_type_breakdown(cost: NetworkCost) -> Dict[str, Dict[str, float]]:
    """Fig 3: per-layer-type cycles vs useful MACs (spatial losses show as
    cycles >> macs/(rows*cols))."""
    hw = cost.hw
    agg: Dict[str, Dict[str, float]] = {}
    for lc in cost.layers:
        op = lc.layer.op
        d = agg.setdefault(op, {"cycles": 0.0, "ideal_cycles": 0.0,
                                "macs": 0.0, "stall_cycles": 0.0})
        d["cycles"] += lc.total_cycles
        d["stall_cycles"] += lc.stall_cycles
        d["macs"] += lc.layer.macs
        d["ideal_cycles"] += lc.layer.macs / (hw.rows * hw.cols)
    return agg


def utilization(cost: NetworkCost) -> float:
    """Achieved MACs/s over peak for the full network."""
    macs = sum(lc.layer.macs for lc in cost.layers)
    return macs / (cost.total_cycles * cost.hw.rows * cost.hw.cols)
