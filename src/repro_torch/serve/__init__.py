"""repro_torch.serve — schedule-cache-backed serving on top of
``repro_torch.search``.

The serving arc: searched schedules are *reused* at request
time, never re-derived — and a request is always answered, even when
the stack misbehaves.  Five pieces:

  store    — ``ServeStore``, the warm artifact store: an in-process
             memory layer over the content-addressed JSON schedule
             cache; ``warm()`` fans the (workload x batch) grid out
             over a process pool, a served lookup is a dict probe.
             ``request()`` walks the graceful-degradation ladder
             (memory -> disk -> retried search -> nearest co-searched
             batch rescaled -> untiled heuristic), so a lookup never
             returns ``None``.
  batcher  — batch co-search (``co_search``): batch is a first-class
             mapspace dim (``core.workload.with_batch``), each level in
             {1, 4, 16, 64} carries its own searched schedule, and the
             latency-vs-batch curve is the policy's input.
  policy   — ``ServePolicy`` / ``pick_batch``: per arrival rate, the
             expected-latency-minimizing batch level (batch-fill wait
             vs dispatch amortization vs data-parallel fan-out over a
             device mesh, ``devices`` wide).
  loop     — the discrete-event request loop (``run_loop`` /
             ``simulate``): Poisson/trace arrivals, batch-fill timers,
             per-request deadlines, a single-server mesh queue —
             validates the policy's ``(b-1)/(2λ)`` fill-wait closed
             form against measured waits.
  chaos    — deterministic fault injection (``ChaosPlan`` /
             ``chaos_session``): crashed workers, torn artifacts, stale
             claim locks, stale-engine artifacts, slow searches — the
             harness behind the "never serves None" acceptance.

CLI: ``PYTHONPATH=src python -m repro_torch.serve --warm --arch edgenext-s``;
``--loop`` runs the simulated request loop, ``--chaos`` a fault
session.
"""
from repro_torch.serve.batcher import BatchPoint, co_search
from repro_torch.serve.chaos import (ChaosMonkey, ChaosPlan, ChaosReport,
                                     DeadlineExceeded, InjectedFault,
                                     chaos_session)
from repro_torch.serve.loop import (LoopReport, model_fill_wait,
                                    poisson_arrivals, run_loop, simulate,
                                    trace_arrivals)
from repro_torch.serve.policy import (BatchPick, ServePolicy, distinct_batches,
                                      pick_batch, rate_table)
from repro_torch.serve.store import (BATCH_LEVELS, LookupResult, ServeStore,
                                     WarmReport, canonical_name,
                                     heuristic_schedule)

__all__ = [
    "BATCH_LEVELS", "BatchPick", "BatchPoint", "ChaosMonkey", "ChaosPlan",
    "ChaosReport", "DeadlineExceeded", "InjectedFault", "LookupResult",
    "LoopReport", "ServePolicy", "ServeStore", "WarmReport",
    "canonical_name", "chaos_session", "co_search", "distinct_batches",
    "heuristic_schedule", "model_fill_wait", "pick_batch",
    "poisson_arrivals", "rate_table", "run_loop", "simulate",
    "trace_arrivals",
]
