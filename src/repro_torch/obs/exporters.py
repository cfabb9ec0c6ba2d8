"""Tracer exporters: Chrome-trace JSON and BENCH rows.

``chrome_trace`` emits the Trace Event Format object consumed by
``chrome://tracing`` and Perfetto — one complete ("ph": "X") event per
span, microsecond timestamps, span attributes under ``args``.  Extra
top-level keys (counters, gauges, phase wall times) ride along for
tooling; the viewers ignore them.

``bench_rows`` turns the tracer's counters/gauges into the repo's BENCH
row triples (name, value, note) under the ``search.obs.*`` prefix, the
same surface ``PerfRecorder.rows`` uses for ``search.perf.*`` — so
decision-provenance counts (mappings pruned, fusion cuts, cache replay
outcomes) land in the benchmark trajectory next to the wall times.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.obs.tracer import Span, Tracer

Row = Tuple[str, float, str]


def _emit(sp: Span, events: List[Dict[str, object]]) -> None:
    events.append({"name": sp.name, "cat": "search", "ph": "X",
                   "ts": sp.t0 * 1e6, "dur": sp.dur_s * 1e6,
                   "pid": 0, "tid": sp.tid, "args": dict(sp.attrs)})
    for c in sp.children:
        _emit(c, events)


def chrome_trace(tracer: Tracer) -> Dict[str, object]:
    """The tracer as a Trace Event Format document (JSON object)."""
    events: List[Dict[str, object]] = []
    for r in tracer.roots:
        _emit(r, events)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "counters": dict(tracer.counters),
                "gauges": dict(tracer.gauges),
                "phase_ms": {k: v * 1e3
                             for k, v in tracer.phase_s.items()}}}


def write_chrome_trace(tracer: Tracer, path) -> Path:
    """Serialize ``chrome_trace(tracer)`` to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer)))
    return path


def bench_rows(tracer: Tracer, prefix: str = "search.obs") -> List[Row]:
    """Counters + gauges + span count as BENCH rows (sorted by name for
    trajectory stability)."""
    out: List[Row] = [(f"{prefix}.spans", float(tracer.span_count()),
                       "recorded spans")]
    for k in sorted(tracer.counters):
        out.append((f"{prefix}.{k}", float(tracer.counters[k]), "counter"))
    for k in sorted(tracer.gauges):
        out.append((f"{prefix}.{k}", tracer.gauges[k], "gauge"))
    return out
