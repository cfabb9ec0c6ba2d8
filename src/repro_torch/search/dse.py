"""Hardware design-space exploration: Pareto sweep over HWSpec variants.

For each candidate accelerator (PE array shape, memory-hierarchy level
sizing) the full auto-scheduler runs and reports the workload's latency
/ energy / EDP — so every point on the front carries its *own* best
schedule, not a schedule tuned for one reference design (the co-search
ZigZag itself performs).

Two sweep axes:
  ``hw_variants`` / ``sweep``   — the PE-shape x SRAM/RF grid;
  ``memory_variants`` / ``sweep_memory`` — per-level hierarchy sizing
    (the L1-vs-L2 tradeoff): every named level sweeps its capacity with
    the access energy scaling as sqrt(capacity) (longer bit/word
    lines), act partitions keeping their share.  The fixed paper spec
    is one grid point, so the Pareto front directly answers whether a
    different on-chip split beats it.

Sweeps are *incremental*: all variants of one sweep share a
``SearchMemo``, so per-layer results whose inputs are invariant under
the varied sizes are solved once — spatial mappings (hierarchy-
independent) span every memory variant, temporal-mapspace tables span
every variant keeping the PE-coupled buffers, per-capacity group tiles
span every variant sharing a residence budget — and only the
placement/ranking decisions that actually read the changed capacities
or energies are re-costed per variant.  ``parallel=N`` instead fans the
variants out over a process pool (each worker dedups within its own
variant); results are identical either way since the memoization is
exact.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.workload import Layer
from repro_torch.search.auto import Schedule, auto_schedule
from repro_torch.search.memo import SearchMemo
from repro_torch.search.perf import PerfRecorder


@dataclasses.dataclass(frozen=True)
class DsePoint:
    rows: int
    cols: int
    sram_kb: int
    rf_kb: int
    latency_s: float
    energy_j: float
    edp: float
    schedule: Schedule
    # hierarchy-sizing sweeps: the swept (level, bytes) assignment
    mem: Tuple[Tuple[str, int], ...] = ()

    @property
    def label(self) -> str:
        if self.mem:
            return "-".join(f"{k}{v // 1024}k" for k, v in self.mem)
        return (f"{self.rows}x{self.cols}pe-{self.sram_kb}kSRAM-"
                f"{self.rf_kb}kRF")


def hw_variants(base: Optional[HWSpec] = None, *,
                pe_shapes: Sequence[Tuple[int, int]] = (
                    (8, 8), (8, 16), (16, 16), (16, 32), (32, 32)),
                sram_kb: Sequence[int] = (256, 512, 1024),
                rf_kb: Sequence[int] = (24,)) -> List[HWSpec]:
    """The swept accelerator grid, area-aware relative to the reference
    16x16 / 512 kB design:

      static power scales with PE count (clock tree + leakage ~ area),
      SRAM pJ/byte scales with sqrt(capacity) (longer bit/word lines),
      the activation budget keeps the reference 3/8 split of SRAM.

    This is what turns the sweep into a real tradeoff: a 32x32 array
    quarters the compute cycles but quadruples leakage, so small
    workloads pay in energy what they gain in latency.
    """
    base = base or HWSpec()
    ref_pes = base.rows * base.cols
    out = []
    for (r, c), skb, rkb in itertools.product(pe_shapes, sram_kb, rf_kb):
        sram = skb * 1024
        out.append(dataclasses.replace(
            base, rows=r, cols=c, sram_bytes=sram,
            act_budget_bytes=int(sram * 3 / 8),
            output_rf_bytes=rkb * 1024,
            static_mw=base.static_mw * (r * c) / ref_pes,
            e_sram_byte=base.e_sram_byte
            * (sram / base.sram_bytes) ** 0.5))
    return out


def _point(hw: HWSpec, sched: Schedule,
           mem: Tuple[Tuple[str, int], ...] = ()) -> DsePoint:
    return DsePoint(
        rows=hw.rows, cols=hw.cols, sram_kb=hw.sram_bytes // 1024,
        rf_kb=hw.output_rf_bytes // 1024,
        latency_s=sched.cost["latency_s"],
        energy_j=sched.cost["energy_j"], edp=sched.cost["edp"],
        schedule=sched, mem=mem)


def _schedule_variant(args):
    """Process-pool worker: one variant, own memo + own recorder
    (module-level so it pickles under the spawn start method too).
    Returns ``(schedule, phase_s, counters, span_tables)`` — the
    recorder's raw tables ride back over the pickle boundary so the
    caller can merge them instead of losing the workers' profile.
    ``span_tables`` is the worker tracer's ``to_tables()`` snapshot
    when the caller had an active tracer (a ``Tracer`` itself is not
    picklable — it holds a lock), else None."""
    layers, hw, workload, dedup, spatial_mode, trace = args
    wperf = PerfRecorder()
    if trace:
        with obs.tracing() as tracer:
            sched = auto_schedule(layers, hw, workload=workload,
                                  dedup=dedup, spatial_mode=spatial_mode,
                                  perf=wperf)
        tables = tracer.to_tables()
    else:
        sched = auto_schedule(layers, hw, workload=workload, dedup=dedup,
                              spatial_mode=spatial_mode, perf=wperf)
        tables = None
    return sched, wperf.phase_s, wperf.counters, tables


def _schedule_variants(layers: List[Layer], variants: Sequence[HWSpec],
                       workload: str, dedup: bool,
                       memo: Optional[SearchMemo],
                       perf: Optional[PerfRecorder],
                       parallel: int,
                       spatial_mode: str = "factored") -> List[Schedule]:
    """One Schedule per variant — serially through a sweep-wide shared
    memo (incremental re-costing), or fanned out over a process pool.
    Each pool worker dedups within its own variant and ships its
    ``PerfRecorder`` tables back with the schedule; the caller's
    ``perf`` merges them, so ``--profile --jobs N`` reports real phase
    times and memo counters (a caller-supplied memo still cannot cross
    process boundaries — passing one with ``parallel`` stays an error
    rather than a silent drop).  Under an active ``obs`` tracer the
    whole sweep is one ``dse`` span; parallel workers additionally ship
    their span trees back (``Tracer.to_tables``) and the caller rebases
    them onto its own clock under the ``dse`` span, one track per
    worker — the span-tree analogue of ``PerfRecorder.merge``."""
    with obs.span("dse", variants=len(variants), parallel=parallel,
                  workload=workload, dedup=dedup):
        if parallel > 1:
            if memo is not None:
                raise ValueError("parallel sweeps cannot share a caller-"
                                 "supplied memo across processes; drop "
                                 "memo= or run serially")
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            act = obs.current()
            base = act.now() if act is not None else 0.0
            # spawned, not forked: the caller may hold threads (torch's)
            # or a CUDA context; a worker imports the search afresh and
            # touches no card
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=parallel,
                                     mp_context=ctx) as ex:
                results = list(ex.map(
                    _schedule_variant,
                    [(layers, hw, workload, dedup, spatial_mode,
                      act is not None)
                     for hw in variants]))
            if perf is not None:
                for _, phase_s, counters, _ in results:
                    perf.merge(phase_s, counters)
            if act is not None:
                # rebase each worker's relative timestamps to the pool
                # launch time on the caller's clock; wall time inside a
                # worker stays exact, cross-worker alignment is bounded
                # by pool startup skew
                for wi, (_, _, _, tables) in enumerate(results):
                    if tables is not None:
                        act.merge_tables(tables, offset=base,
                                         label=f"worker{wi}")
            return [sched for sched, _, _, _ in results]
        if memo is None and dedup:
            memo = SearchMemo(perf=perf)
        return [auto_schedule(layers, hw, workload=workload, dedup=dedup,
                              spatial_mode=spatial_mode, memo=memo,
                              perf=perf)
                for hw in variants]


def sweep(layers: List[Layer], variants: Optional[Iterable[HWSpec]] = None,
          *, workload: str = "custom", dedup: bool = True,
          memo: Optional[SearchMemo] = None,
          perf: Optional[PerfRecorder] = None,
          parallel: int = 0,
          spatial_mode: str = "factored") -> List[DsePoint]:
    """Run the auto-scheduler on every HW variant.  All variants share
    one ``SearchMemo`` (pass ``memo`` to extend the sharing across
    sweeps, ``dedup=False`` for the brute-force baseline, ``parallel=N``
    for a process-pool fan-out, ``perf`` to collect phase times and memo
    hit rates across the whole sweep — parallel workers merge theirs
    back, ``spatial_mode="pair"`` for the pair-only ablation)."""
    hws = list(variants if variants is not None else hw_variants())
    scheds = _schedule_variants(layers, hws, workload, dedup, memo, perf,
                                parallel, spatial_mode)
    return [_point(hw, sched) for hw, sched in zip(hws, scheds)]


def memory_variants(base: Optional[HWSpec] = None, *,
                    sizings: Mapping[str, Sequence[int]]) -> List[HWSpec]:
    """The hierarchy-sizing grid: the cross product of per-level
    capacities in ``sizings`` (level name -> byte options).  Each resized
    level scales its pJ/byte by sqrt(capacity ratio) — the same
    longer-bit/word-line model the PE-shape sweep applies to the SRAM —
    and ``MemoryHierarchy.resized`` keeps partition shares (the act 3/8
    of the SRAM, the input/output split of the RF).  Level capacities of
    the base spec reproduce the base point exactly.
    """
    base = base or HWSpec()
    names = [n for n in base.hierarchy.names if n in sizings]
    unknown = set(sizings) - set(base.hierarchy.names)
    if unknown:
        raise KeyError(f"no such memory level(s): {sorted(unknown)}; "
                       f"hierarchy has {base.hierarchy.names}")
    for n in names:
        if not base.hierarchy.level(n).bounded:
            raise ValueError(
                f"cannot sweep the unbounded backing store {n!r} — "
                f"sweep a bounded on-chip level instead")
    out: List[HWSpec] = []
    for combo in itertools.product(*(sizings[n] for n in names)):
        h = base.hierarchy
        for name, nbytes in zip(names, combo):
            lvl = h.level(name)
            scale = (nbytes / lvl.bytes) ** 0.5 if lvl.bounded else 1.0
            h = h.resized(name, bytes=nbytes,
                          pj_per_byte=lvl.pj_per_byte * scale)
        out.append(dataclasses.replace(base, hierarchy=h))
    return out


def sweep_memory(layers: List[Layer], base: Optional[HWSpec] = None, *,
                 sizings: Mapping[str, Sequence[int]],
                 workload: str = "custom", dedup: bool = True,
                 memo: Optional[SearchMemo] = None,
                 perf: Optional[PerfRecorder] = None,
                 parallel: int = 0,
                 spatial_mode: str = "factored") -> List[DsePoint]:
    """Run the auto-scheduler over a hierarchy-sizing grid; points are
    labeled by their per-level byte assignment (e.g. ``rf32k-sram256k``).
    Incremental: the sweep-wide shared memo re-uses every sub-result
    whose inputs the resized levels do not touch (see module docstring);
    ``dedup=False`` is the from-scratch baseline the ``search.perf.*``
    speedup rows measure against."""
    base = base or HWSpec()
    hws = memory_variants(base, sizings=sizings)
    scheds = _schedule_variants(layers, hws, workload, dedup, memo, perf,
                                parallel, spatial_mode)
    return [_point(hw, sched,
                   mem=tuple((l.name, l.bytes)
                             for l in hw.hierarchy.levels
                             if l.name in sizings))
            for hw, sched in zip(hws, scheds)]


def dominates(a: DsePoint, b: DsePoint) -> bool:
    return (a.latency_s <= b.latency_s and a.energy_j <= b.energy_j
            and (a.latency_s < b.latency_s or a.energy_j < b.energy_j))


def pareto_front(points: Sequence[DsePoint]) -> List[DsePoint]:
    """Non-dominated (latency, energy) subset, latency-sorted."""
    front = [p for p in points
             if not any(dominates(q, p) for q in points if q is not p)]
    # drop duplicate (latency, energy) pairs deterministically
    seen: Dict[Tuple[float, float], DsePoint] = {}
    for p in sorted(front, key=lambda p: (p.latency_s, p.energy_j,
                                          p.label)):
        seen.setdefault((p.latency_s, p.energy_j), p)
    return list(seen.values())


def edp_best(points: Sequence[DsePoint]) -> DsePoint:
    return min(points, key=lambda p: (p.edp, p.label))
