"""Discrete-event serving loop: sampled arrivals against the policy.

``ServePolicy`` picks batch levels off a *closed form* — a request
waits on average ``(b-1)/(2λ)`` for its batch to fill at arrival rate
λ.  This module earns that formula: a deterministic discrete-event
simulation (virtual time only, no wall clock, no threads) draws Poisson
or trace arrivals, groups them into batches with a fill timer, runs the
batches through a single-server queue (the whole data-parallel mesh
serves one batch at a time — that is the dispatch model the policy
costs), applies per-request deadlines, and reports the *measured* mean
fill wait next to the closed form.  The relative gap
(``LoopReport.fillwait_err``) is asserted under 10% at the swept rates.

Two layers:

  ``simulate``  — the pure queueing core: arrival times in, a
                  ``LoopReport`` out.  Deterministic given its inputs;
                  the unit tests pin it against hand-computed traces.
  ``run_loop``  — the end-to-end driver: co-searches the batch curve
                  through a ``ServeStore`` (so faults and degradations
                  surface exactly as in real serving), asks the policy
                  for a batch level at the target rate, takes the
                  *sharded* service latency the policy costed, and
                  simulates.  Emits ``serve.loop.*`` counters/gauges.

Measurement notes, pinned here because they are easy to get subtly
wrong:

  * the fill-wait mean is taken over **full batches only** — a partial
    tail batch flushed by the fill timer (or end-of-stream) waits the
    timer, not the fill, and would bias the comparison against a
    closed form that models full batches;
  * at ``b == 1`` the model says 0 and a batch "fills" on arrival, so
    measured is identically 0 and the error is defined as 0;
  * the closed form models *fill* wait only — queueing delay behind a
    busy server is real, is reported separately (``queue_wait``), and
    is NOT part of the comparison.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from repro_torch import obs

# arrival rates (requests/s) the fill-wait validation sweeps —
# the same grid the policy table uses
LOOP_RATES = (2.0, 15.0, 60.0)


def poisson_arrivals(n: int, rate_rps: float, *, seed: int = 0
                     ) -> List[float]:
    """``n`` Poisson arrival times at rate λ (exponential
    inter-arrivals), deterministic per seed."""
    if rate_rps <= 0:
        raise ValueError("poisson_arrivals needs rate_rps > 0")
    rng = random.Random(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(t)
    return out


def trace_arrivals(interarrival_s: Sequence[float]) -> List[float]:
    """Arrival times from a recorded inter-arrival trace."""
    t = 0.0
    out = []
    for gap in interarrival_s:
        t += float(gap)
        out.append(t)
    return out


def model_fill_wait(batch: int, rate_rps: float) -> float:
    """The policy's closed form: mean fill wait ``(b-1)/(2λ)``."""
    if batch <= 1:
        return 0.0
    if rate_rps <= 0:
        return float("inf")
    return (batch - 1) / (2.0 * rate_rps)


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One simulated request, all times in virtual seconds."""
    index: int
    arrival_s: float
    dispatched_s: float            # its batch left the fill stage
    started_s: float               # its batch reached the server
    done_s: float
    batch: int                     # size its batch dispatched at
    full: bool                     # batch filled (vs timer/stream flush)
    deadline_miss: bool

    @property
    def fill_wait_s(self) -> float:
        return self.dispatched_s - self.arrival_s

    @property
    def queue_wait_s(self) -> float:
        return self.started_s - self.dispatched_s

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s


@dataclasses.dataclass(frozen=True)
class LoopReport:
    """What one simulated session measured."""
    rate_rps: float
    batch: int                     # configured batch level
    requests: int
    batches: int
    partial_batches: int           # flushed by timer / end of stream
    deadline_misses: int
    fill_wait_mean_s: float        # over requests in FULL batches only
    model_fill_wait_s: float       # (b-1)/(2λ)
    queue_wait_mean_s: float
    latency_mean_s: float
    latency_p99_s: float
    makespan_s: float              # last completion time
    records: Tuple[RequestRecord, ...]

    @property
    def fillwait_err(self) -> float:
        """|measured - model| / model; 0 when both are 0 (b == 1)."""
        if self.model_fill_wait_s <= 0:
            return abs(self.fill_wait_mean_s)   # 0 in the defined case
        return abs(self.fill_wait_mean_s - self.model_fill_wait_s) \
            / self.model_fill_wait_s


def _p99(xs: List[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def simulate(arrivals: Sequence[float], *, batch: int,
             service_s: float, dispatch_s: float = 0.0,
             fill_timeout_s: Optional[float] = None,
             deadline_s: Optional[float] = None,
             rate_rps: float = 0.0) -> LoopReport:
    """The pure queueing core (see the module docstring).

    Batching: consecutive arrivals fill a batch of ``batch``; the batch
    dispatches when full, or — with a fill timer — at
    ``first_arrival + fill_timeout_s`` if the timer beats the fill (a
    deadline-bounded deployment always runs one).  A partial batch left
    at end of stream flushes at its timer expiry, else at its last
    member's arrival.  Service: one server (the whole mesh), FIFO,
    ``dispatch_s + service_s`` per batch regardless of occupancy (a
    padded partial batch costs the full launch — that is why partials
    are counted)."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    arrivals = sorted(float(a) for a in arrivals)
    # --- fill stage: group arrivals into dispatched batches ----------
    groups: List[Tuple[List[int], float, bool]] = []  # (idx, t, full)
    cur: List[int] = []
    t_first = 0.0
    for i, t in enumerate(arrivals):
        if not cur:
            t_first = t
        if fill_timeout_s is not None and cur and \
                t > t_first + fill_timeout_s:
            # the timer expired before this arrival: flush the partial
            groups.append((cur, t_first + fill_timeout_s, False))
            cur, t_first = [], t
        cur.append(i)
        if len(cur) == batch:
            groups.append((cur, t, True))
            cur = []
    if cur:
        flush = t_first + fill_timeout_s if fill_timeout_s is not None \
            else arrivals[cur[-1]]
        groups.append((cur, flush, False))
    # --- service stage: FIFO single-server queue ---------------------
    records: List[Optional[RequestRecord]] = [None] * len(arrivals)
    free_at = 0.0
    for idxs, t_disp, full in groups:
        start = max(t_disp, free_at)
        done = start + dispatch_s + service_s
        free_at = done
        for i in idxs:
            miss = deadline_s is not None and \
                (done - arrivals[i]) > deadline_s
            records[i] = RequestRecord(
                index=i, arrival_s=arrivals[i], dispatched_s=t_disp,
                started_s=start, done_s=done, batch=len(idxs),
                full=full, deadline_miss=miss)
    recs = [r for r in records if r is not None]
    full_waits = [r.fill_wait_s for r in recs if r.full]
    lat = [r.latency_s for r in recs]
    return LoopReport(
        rate_rps=rate_rps, batch=batch, requests=len(recs),
        batches=len(groups),
        partial_batches=sum(1 for _, _, f in groups if not f),
        deadline_misses=sum(r.deadline_miss for r in recs),
        fill_wait_mean_s=(sum(full_waits) / len(full_waits)
                          if full_waits else 0.0),
        model_fill_wait_s=model_fill_wait(batch, rate_rps),
        queue_wait_mean_s=(sum(r.queue_wait_s for r in recs) / len(recs)
                           if recs else 0.0),
        latency_mean_s=sum(lat) / len(lat) if lat else 0.0,
        latency_p99_s=_p99(lat),
        makespan_s=max((r.done_s for r in recs), default=0.0),
        records=tuple(recs))


def run_loop(store, workload: str, *, rate_rps: float,
             n_requests: int = 2000, seed: int = 0,
             batch: Optional[int] = None,
             batches: Optional[Sequence[int]] = None,
             dispatch_s: float = 0.020, devices: int = 1,
             fill_timeout_s: Optional[float] = None,
             deadline_s: Optional[float] = None,
             arrivals: Optional[Sequence[float]] = None) -> LoopReport:
    """Drive ``ServeStore`` + ``ServePolicy`` end to end under sampled
    load.  Co-searches the batch curve through the store's serving
    ladder (so injected faults degrade here exactly as in production),
    lets the policy pick the level for ``rate_rps`` (or honors an
    explicit ``batch``), takes the sharded service latency the policy
    costed, and simulates the event loop.  Reports through
    ``serve.loop.*`` counters/gauges."""
    from repro_torch.serve.batcher import co_search
    from repro_torch.serve.policy import ServePolicy
    from repro_torch.serve.store import BATCH_LEVELS
    levels = tuple(batches) if batches else BATCH_LEVELS
    with obs.span("serve.loop", workload=workload, rate_rps=rate_rps,
                  n=n_requests):
        points = co_search(store, workload, batches=levels)
        pol = ServePolicy(dispatch_s=dispatch_s, devices=devices)
        pick = pol.pick(points, rate_rps)
        b = batch if batch is not None else pick.point.batch
        service_s = pick.shard_point.latency_s if batch is None else \
            next(p for p in points if p.batch == b).latency_s
        if arrivals is None:
            arrivals = poisson_arrivals(n_requests, rate_rps, seed=seed)
        rep = simulate(arrivals, batch=b, service_s=service_s,
                       dispatch_s=dispatch_s,
                       fill_timeout_s=fill_timeout_s,
                       deadline_s=deadline_s, rate_rps=rate_rps)
        obs.count("serve.loop.requests", rep.requests)
        obs.count("serve.loop.batches", rep.batches)
        obs.count("serve.loop.partial_batches", rep.partial_batches)
        obs.count("serve.loop.deadline_miss", rep.deadline_misses)
        obs.gauge("serve.loop.fill_wait_mean_s", rep.fill_wait_mean_s)
        obs.gauge("serve.loop.fillwait_err", rep.fillwait_err)
        obs.event("serve.loop.report", workload=workload,
                  rate_rps=rate_rps, batch=b,
                  fill_wait_mean_s=rep.fill_wait_mean_s,
                  model_fill_wait_s=rep.model_fill_wait_s,
                  fillwait_err=rep.fillwait_err,
                  deadline_misses=rep.deadline_misses)
    return rep
