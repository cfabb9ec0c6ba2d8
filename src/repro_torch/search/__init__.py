"""repro_torch.search — the ZigZag-style auto-scheduler, and its lowering
onto the port's CUDA kernels.

  mapper     spatial mappings + temporal loop orders per layer
  partition  DP fusion partitioner over the layer chain
  tiler      budget-driven tile search for depth-first groups
  dse        Pareto sweep over HWSpec variants (sweep-wide shared memo,
             optional process-pool fan-out)
  lower      schedule -> launch parameters of the Hopper kernels
             (``block_*`` values the kernels really run)
  cache      JSON schedule artifacts + content-addressed cache
             (``<workload>-hopper-<key>.json``)
  memo       unique-layer memo tables (``SearchMemo``)
  perf       phase timers + memo counters (``PerfRecorder``)
  auto       the orchestrator (``auto_schedule``; ``dedup=False`` is
             the bit-exact brute-force equivalence mode)

Every module but ``lower`` is a copy of the JAX package's and gives the
same schedule document in every field but ``lowered``.

CLI: ``PYTHONPATH=src python -m repro_torch.search --workload edgenext-s``.
"""
import re

from repro_torch.search.auto import Schedule, auto_schedule, evaluate_schedule
from repro_torch.search.cache import (cached_search, load_schedule,
                                      save_schedule, schedule_key)
from repro_torch.search.dse import (DsePoint, edp_best, hw_variants,
                                    memory_variants, pareto_front, sweep,
                                    sweep_memory)

__all__ = [
    "Schedule", "auto_schedule", "evaluate_schedule", "cached_search",
    "load_schedule", "save_schedule", "schedule_key", "DsePoint",
    "edp_best", "hw_variants", "memory_variants", "pareto_front", "sweep",
    "sweep_memory", "WORKLOADS", "get_workload", "parse_workload",
]


def get_workload(name: str):
    """Named workload registry.  A ``-b<N>`` suffix on any registered
    base name is the batch-``N`` serving shape
    (``core.workload.with_batch``): ``edgenext-s-b4`` is EdgeNeXt-S at
    batch 4."""
    from repro_torch.configs.edgenext_s import CONFIG, reduced_edgenext
    from repro_torch.core.workload import (edgenext_workload,
                                           efficientvit_workload,
                                           fastvit_workload,
                                           mobilevit_workload,
                                           recurrentgemma_workload,
                                           rwkv6_workload, vit_workload,
                                           with_batch)
    builders = {
        "edgenext-s": lambda: edgenext_workload(CONFIG),
        "edgenext-reduced": lambda: edgenext_workload(reduced_edgenext()),
        "vit-tiny": lambda: vit_workload(),
        "efficientvit-b0": lambda: efficientvit_workload(),
        "mobilevit-s": lambda: mobilevit_workload(),
        "fastvit-s": lambda: fastvit_workload(),
        "rwkv6": lambda: rwkv6_workload(),
        "recurrentgemma": lambda: recurrentgemma_workload(),
    }
    base, batch = parse_workload(name)
    if base not in builders:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choose from {sorted(builders)} "
                       f"(optionally with a -b<N> batch suffix)")
    layers = builders[base]()
    return with_batch(layers, batch) if batch != 1 else layers


def parse_workload(name: str) -> tuple:
    """Split a registry name into ``(base, batch)``: a trailing
    ``-b<N>`` is the serving-batch suffix (``edgenext-s-b4`` ->
    ``("edgenext-s", 4)``), anything else is batch 1."""
    m = re.fullmatch(r"(.+)-b(\d+)", name)
    if m and int(m.group(2)) >= 1:
        return m.group(1), int(m.group(2))
    return name, 1


WORKLOADS = ("edgenext-s", "edgenext-s-b4", "edgenext-reduced", "vit-tiny",
             "efficientvit-b0", "mobilevit-s", "mobilevit-s-b4",
             "fastvit-s", "fastvit-s-b4", "rwkv6", "recurrentgemma")
