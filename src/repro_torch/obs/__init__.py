"""repro_torch.obs — observability for the scheduler stack.

Three pieces:

  ``tracer``    — hierarchical span ``Tracer`` (nested wall-time spans
                  with attributes, thread/process-safe), typed
                  counters/gauges, and the ambient hooks
                  (``span``/``count``/``gauge``/``event``) every
                  instrumentation site in ``repro_torch.search`` calls;
                  all no-ops when no tracer is active, so an untraced
                  search pays one ``None`` check per hook.  The static
                  checker reports ``check.pass`` / ``check.fail``
                  through the same hooks.
  ``exporters`` — Chrome-trace/Perfetto JSON (``--trace out.json``,
                  load in ``chrome://tracing``) and ``search.obs.*``
                  BENCH rows.
  ``explain``   — the markdown "schedule explain" report behind the
                  CLI's ``--explain`` (per-layer mapping decisions,
                  per-level traffic/energy breakdown, fusion groups).

Typical capture::

    from repro_torch import obs
    with obs.tracing() as tracer:
        sched = auto_schedule(layers, hw, workload="edgenext-s")
    obs.write_chrome_trace(tracer, "trace.json")
    print(obs.explain_schedule(layers, sched, hw))
"""
from repro_torch.obs.tracer import (Span, Tracer, activate, count, current,
                                    event, gauge, span, tracing)
from repro_torch.obs.exporters import (bench_rows, chrome_trace,
                                       write_chrome_trace)
from repro_torch.obs.explain import explain_schedule

__all__ = [
    "Span", "Tracer", "activate", "count", "current", "event", "gauge",
    "span", "tracing",
    "bench_rows", "chrome_trace", "write_chrome_trace",
    "explain_schedule",
]
