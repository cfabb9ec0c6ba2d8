"""Batch co-search: the latency-vs-batch curve behind dynamic batching.

Batch is a first-class mapspace dim (``core.workload.with_batch``
rescales the ``b`` loop extent, changing every content signature), so
each batch level gets its *own* searched schedule — tile shapes and
spatial replication genuinely differ between the batch-1 latency point
and the batch-64 throughput point on the odd hybrid-ViT channel dims.
``co_search`` pulls one ``BatchPoint`` per level out of the warm store
(paying a lookup when warm, a search exactly once when not) and the
policy (``serve.policy``) picks a level per arrival rate off the curve.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.serve.store import BATCH_LEVELS, ServeStore


@dataclasses.dataclass(frozen=True)
class BatchPoint:
    """One point on a workload's latency-vs-batch curve."""
    workload: str                  # canonical name (base-b<N>)
    batch: int
    latency_s: float               # modeled service latency of the batch
    energy_j: float
    edp: float
    key: str                       # schedule content hash
    degraded: bool = False         # served off the degradation ladder

    @property
    def throughput_rps(self) -> float:
        """Requests per second at back-to-back batch launches (no
        dispatch overhead — the policy adds that per deployment)."""
        return self.batch / self.latency_s

    @property
    def latency_per_req_ms(self) -> float:
        return self.latency_s * 1e3 / self.batch


def co_search(store: ServeStore, workload: str, *,
              batches: Sequence[int] = BATCH_LEVELS) -> List[BatchPoint]:
    """The co-searched batch curve for one workload, batch-sorted.
    Every point carries its own searched schedule's cost numbers; the
    schedules themselves stay resident in the store.  Points served off
    the degradation ladder (search down, neighbor-rescaled or heuristic
    cost) arrive flagged ``degraded`` — the policy still works, the
    curve is just approximate until the fault clears."""
    pts: List[BatchPoint] = []
    for b in sorted(set(batches)):
        res = store.request(workload, b)
        sched = res.schedule
        pts.append(BatchPoint(
            workload=res.workload, batch=b,
            latency_s=sched.cost["latency_s"],
            energy_j=sched.cost["energy_j"],
            edp=sched.cost["edp"], key=res.key,
            degraded=res.degraded))
    return pts
