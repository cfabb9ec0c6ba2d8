"""Arrival-rate batching policy: pick the batch level per traffic load.

The accelerator model's latency is essentially linear in batch (the
array is compute-bound and near-fully utilized at every level), so
batching pays through the two terms *outside* the MAC loop nest:

  dispatch — a fixed per-launch overhead (host round-trip, schedule
             dispatch, weight upload ahead of the batch) amortized over
             the batch: throughput b / (dispatch + lat(b)) grows with b
             toward the accelerator's native rate;
  fan-out  — a mesh of ``devices`` array instances serves one batch-b
             arrival group as data-parallel shards of b/devices
             (``devices`` is a number here: no mesh is built), so the
             service latency of a large batch is the *searched* latency
             of the smaller per-shard schedule — the policy only uses
             shard levels that were actually co-searched, never a scaled
             guess.

Against that, small batches win the batch-fill wait: at arrival rate
λ, a request waits on average (b-1)/(2λ) for its batch to fill.  The
policy minimizes expected request latency

    fill wait + dispatch + service latency(shard)

over the co-searched levels whose sustained throughput covers λ; when
no level covers λ (saturation) it falls back to the max-throughput
level, which drains the backlog fastest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.serve.batcher import BatchPoint


@dataclasses.dataclass(frozen=True)
class BatchPick:
    """The policy's verdict for one arrival rate."""
    rate_rps: float
    point: BatchPoint              # chosen batch level
    shard_point: BatchPoint        # per-device schedule actually run
    devices: int                   # data-parallel width used
    expected_latency_s: float      # fill wait + dispatch + service
    sustained_rps: float           # throughput ceiling at this pick
    saturated: bool                # True: no level covered the rate


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """``dispatch_s`` is the per-batch launch overhead; ``devices`` the
    data-parallel mesh width available to shard a batch over."""
    dispatch_s: float = 0.020
    devices: int = 1

    def _shard(self, p: BatchPoint,
               by_batch: Dict[int, BatchPoint]) -> tuple:
        """(per-shard point, width): the widest fan-out <= devices whose
        per-shard batch level was co-searched."""
        d = self.devices
        while d > 1:
            if p.batch % d == 0 and p.batch // d in by_batch:
                return by_batch[p.batch // d], d
            d -= 1
        return p, 1

    def evaluate(self, points: Sequence[BatchPoint],
                 rate_rps: float) -> List[BatchPick]:
        """One BatchPick per co-searched level (policy introspection).

        Two boundary cases are defined, not incidental:

          * ``rate_rps == 0`` — the fill-wait closed form ``(b-1)/(2λ)``
            diverges (a batch of 2 literally never fills when nothing
            arrives), so every level above batch 1 is marked saturated
            and its fill wait pinned to ``inf``; batch 1 needs no fill
            and keeps its finite latency, making it the only feasible
            pick (pinned in tests).
          * ``rate_rps`` exactly at a level's sustained ceiling — the
            level still covers the rate (``saturated`` uses a strict
            ``<``), so an arrival stream running a level at exactly
            100% utilization is feasible, never a silent fallback.
        """
        by_batch = {p.batch: p for p in points}
        out: List[BatchPick] = []
        for p in sorted(points, key=lambda q: q.batch):
            shard, d = self._shard(p, by_batch)
            service = shard.latency_s
            sustained = p.batch / (self.dispatch_s + service)
            if rate_rps > 0:
                fill = (p.batch - 1) / (2.0 * rate_rps)
                saturated = sustained < rate_rps
            else:
                # zero (or negative) arrival rate: only batch 1 ever
                # dispatches — larger batches wait forever for a fill
                fill = 0.0 if p.batch == 1 else float("inf")
                saturated = p.batch != 1
            out.append(BatchPick(
                rate_rps=rate_rps, point=p, shard_point=shard, devices=d,
                expected_latency_s=fill + self.dispatch_s + service,
                sustained_rps=sustained,
                saturated=saturated))
        return out

    def pick(self, points: Sequence[BatchPoint],
             rate_rps: float) -> BatchPick:
        """The chosen level for one arrival rate (see module docstring).
        ``rate_rps <= 0`` picks the smallest batch level (batch 1 when
        co-searched: with no arrivals to fill a batch, anything larger
        would wait forever)."""
        if not points:
            raise ValueError("no co-searched batch points to pick from")
        cands = self.evaluate(points, rate_rps)
        if rate_rps <= 0:
            # zero-rate: batch 1 (or the smallest co-searched level) —
            # the only one a single stray request ever dispatches
            return min(cands, key=lambda c: c.point.batch)
        feasible = [c for c in cands if not c.saturated]
        if feasible:
            return min(feasible, key=lambda c: (c.expected_latency_s,
                                                c.point.batch))
        # saturated: every level is over capacity — drain fastest
        best = max(cands, key=lambda c: (c.sustained_rps, -c.point.batch))
        return best


def pick_batch(points: Sequence[BatchPoint], rate_rps: float, *,
               dispatch_s: float = 0.020,
               devices: int = 1) -> BatchPick:
    """Functional shorthand over ``ServePolicy``."""
    return ServePolicy(dispatch_s=dispatch_s,
                       devices=devices).pick(points, rate_rps)


def rate_table(points: Sequence[BatchPoint],
               rates: Sequence[float], *,
               dispatch_s: float = 0.020,
               devices: int = 1,
               ) -> List[BatchPick]:
    """The policy's pick at each arrival rate — the CLI table."""
    pol = ServePolicy(dispatch_s=dispatch_s, devices=devices)
    return [pol.pick(points, r) for r in rates]


def distinct_batches(picks: Sequence[BatchPick]) -> int:
    """How many different batch levels a set of picks spans (the
    non-degeneracy acceptance: >= 2 across the swept rates)."""
    return len({p.point.batch for p in picks})


def parse_rates(spec: Optional[str],
                default: Sequence[float] = (2.0, 15.0, 60.0)
                ) -> List[float]:
    """CLI helper: ``"2,15,60"`` -> [2.0, 15.0, 60.0]."""
    if not spec:
        return list(default)
    return [float(t) for t in spec.split(",") if t.strip()]
