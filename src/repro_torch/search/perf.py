"""Instrumentation for the search fast path — the ``search.perf.*``
surface.

A ``PerfRecorder`` accumulates per-phase wall time (spatial mapping,
fusion DP, temporal orders, lowering, evaluation) and memo hit/miss
counters across one ``auto_schedule`` call or one whole DSE sweep
(recorders are additive: pass the same instance to every variant).  The
benchmarks (``benchmarks/dse.py``) and the ``--profile`` CLI flag turn
one recorder into ``search.perf.*`` rows, so scheduler speed is tracked
in the BENCH trajectory exactly like the schedules it produces.

Since the ``repro_torch.obs`` tracer landed, a recorder is a *compatibility
view* over an ``obs.Tracer``: ``phase_s`` and ``counters`` are the
tracer's own tables (one private tracer per recorder by default, or
pass ``tracer=`` to share), and every ``phase`` additionally opens an
*ambient* span via ``repro_torch.obs`` — so when a tracer is active
(``obs.tracing()``, the CLI's ``--trace``) the phases appear nested
under the enclosing ``auto``/``dse`` spans in the Chrome trace, while
the ``search.perf.*`` rows stay bit-identical to the pre-tracer
surface (same float accumulation order, same row set — pinned by
``tests/test_search_perf.py``).

Nothing here is load-bearing for search results: with no recorder the
fast path runs uninstrumented (``phase`` degrades to a no-op), and the
counters never feed back into any decision.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch import obs
from repro_torch.obs.tracer import Tracer

Row = Tuple[str, float, str]


class PerfRecorder:
    """Per-phase wall time + memo hit/miss counters for one search run
    (or one DSE sweep — times and counts accumulate across calls).
    A thin view over an ``obs.Tracer``: the tracer owns the tables."""

    def __init__(self, tracer: Optional[Tracer] = None) -> None:
        self.tracer = tracer if tracer is not None else Tracer()

    @property
    def phase_s(self) -> Dict[str, float]:
        return self.tracer.phase_s

    @property
    def counters(self) -> Dict[str, int]:
        return self.tracer.counters

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        # the ambient span (a no-op when no tracer is active) nests the
        # phase under whatever span encloses this call; the wall-time
        # accumulation below is the legacy surface and keeps its exact
        # float-add order so ``search.perf.*`` rows stay bit-identical
        with obs.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                ph = self.tracer.phase_s
                ph[name] = ph.get(name, 0.0) + time.perf_counter() - t0

    def count(self, key: str, n: int = 1) -> None:
        c = self.tracer.counters
        c[key] = c.get(key, 0) + n

    def merge(self, phase_s: Dict[str, float],
              counters: Dict[str, int]) -> None:
        """Fold another recorder's raw tables into this one — how a
        parallel sweep's per-worker recorders (serialized back as plain
        dicts across the process boundary) accumulate into the caller's
        recorder instead of being dropped.  The workers' span *trees*
        travel separately (``obs.Tracer.to_tables`` /
        ``merge_tables``); this merge is the flat-table half."""
        ph = self.tracer.phase_s
        for k, v in phase_s.items():
            ph[k] = ph.get(k, 0.0) + v
        for k, v in counters.items():
            self.count(k, v)

    # -- derived ------------------------------------------------------

    @property
    def total_s(self) -> float:
        return sum(self.phase_s.values())

    def hit_rate(self, table: str = "") -> float:
        """Memo hit fraction over every ``memo.<table>.hit/miss``
        counter pair (restricted to one table when given); 0.0 with no
        lookups recorded."""
        prefix = f"memo.{table}" if table else "memo."
        hits = sum(v for k, v in self.counters.items()
                   if k.startswith(prefix) and k.endswith(".hit"))
        miss = sum(v for k, v in self.counters.items()
                   if k.startswith(prefix) and k.endswith(".miss"))
        return hits / (hits + miss) if hits + miss else 0.0

    def rows(self, prefix: str = "search.perf") -> List[Row]:
        """The instrumentation as benchmark rows: per-phase wall-time,
        total, and per-table + overall memo hit rates."""
        out: List[Row] = []
        for name in sorted(self.phase_s):
            out.append((f"{prefix}.phase.{name}_ms",
                        self.phase_s[name] * 1e3, "wall time"))
        if self.phase_s:
            out.append((f"{prefix}.total_ms", self.total_s * 1e3,
                        "sum of instrumented phases"))
        tables = sorted({k.split(".")[1] for k in self.counters
                         if k.startswith("memo.")})
        for t in tables:
            hits = self.counters.get(f"memo.{t}.hit", 0)
            miss = self.counters.get(f"memo.{t}.miss", 0)
            out.append((f"{prefix}.memo.{t}.hit_rate", self.hit_rate(t),
                        f"{hits} hits / {miss} misses"))
        if tables:
            out.append((f"{prefix}.memo.hit_rate", self.hit_rate(),
                        "all memo tables"))
        return out
