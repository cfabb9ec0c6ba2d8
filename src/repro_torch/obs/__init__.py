"""repro_torch.obs — the tracer hooks the scheduler stack reports through.

``Tracer`` records nested wall-time spans, counters and gauges; the
ambient hooks (``span`` / ``count`` / ``gauge`` / ``event``) route to the
tracer that ``tracing()`` installed and are no-ops when none is active,
so an untraced search pays one ``None`` check per hook.  The exporters
and the explain report of the JAX package are not ported yet.

    from repro_torch import obs
    with obs.tracing() as tracer:
        sched = auto_schedule(layers, hw, workload="edgenext-s")
    print(tracer.counters)
"""
from repro_torch.obs.tracer import (Span, Tracer, activate, count, current,
                                    event, gauge, span, tracing)

__all__ = ["Span", "Tracer", "activate", "count", "current", "event",
           "gauge", "span", "tracing"]
