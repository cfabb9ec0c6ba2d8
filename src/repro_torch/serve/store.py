"""The warm artifact store: schedule lookups at request time.

A serving front-end must never pay the DP for a workload it has seen
before — and must never answer ``None`` when the stack misbehaves.
``ServeStore`` layers two caches over the auto-scheduler and a
graceful-degradation ladder under them:

  memory   — an in-process dict keyed by the content hash
             (``search.cache.schedule_key``), filled by ``warm()`` /
             first lookup; a hot-path hit is a dict probe plus nothing
             (no JSON parse, no remap), two-plus orders of magnitude
             under the cold search;
  disk     — the content-addressed JSON artifact cache
             (``search.cache.try_replay``, files named by
             ``search.cache.artifact_name``), shared across processes
             and across restarts; misses fall through to the DP and
             store atomically.

A request is ``(workload, batch)`` against one ``HWSpec`` + tile/spatial
mode, i.e. the full ``(workload_sig, hw_sig, tile_mode, spatial_mode,
batch)`` tuple — ``schedule_key`` hashes the batched layer signatures,
the HW signature, and both mode strings, so every component of the
request is in the key.  Per-request layer lists and keys are resolved
once and memoized (a serving loop asks for the same few endpoints
millions of times).

The degradation ladder (``request``) — a lookup walks down until
something serves, so it never returns ``None``:

  1. memory hit                    (``serve.store.mem_hit``)
  2. disk replay                   (artifact parse + remap)
  3. cold search, wrapped in a deadline + retry-with-exponential-
     backoff envelope              (``serve.retry.*`` counters)
  4. the nearest co-searched batch level, cost-rescaled to the
     requested batch and flagged degraded
                                   (``serve.degrade.nearest_batch``)
  5. an on-the-fly untiled heuristic schedule — per-layer spatial
     mapping + loop order only, no fusion DP, no tile search — which
     cannot fail                   (``serve.degrade.heuristic``)

Rungs 4–5 never write the cache (a degraded answer must not shadow the
real schedule once the fault clears) and their results carry
``degraded`` both on the ``LookupResult`` and as an attribute on the
returned ``Schedule``.

``warm()`` fans the (workload x batch) grid out over a spawned process
pool (the same ``--jobs`` shape as the DSE sweeps); each worker runs
``cached_search`` against the shared cache dir — the per-key store
claim in ``search.cache`` guarantees exactly one artifact write per key
no matter how the pool races — and the parent then faults every
artifact into memory.  A worker that dies (``serve.warm.worker_failed``)
only costs its head start: the parent's serial faulting pass re-runs
that grid point through the full serving ladder.  Every outcome is
visible through the ``cache.*`` obs counters (+ ``serve.store.mem_hit``
for memory-layer hits).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.workload import Layer
from repro_torch.search import get_workload, parse_workload
from repro_torch.search.cache import (artifact_name, cached_search,
                                      schedule_key, try_replay)
from repro_torch.serve import chaos as chaos_mod
from repro_torch.serve.chaos import DeadlineExceeded

# the co-searched serving batch levels (the -b4 registry shapes
# generalized to a per-traffic-level family)
BATCH_LEVELS = (1, 4, 16, 64)

_UNSET = object()          # "use the store's default deadline" sentinel


def canonical_name(workload: str, batch: int) -> str:
    """Registry name of one (workload, batch) request: the base name
    for batch 1, the ``-b<N>`` serving shape otherwise."""
    base, b0 = parse_workload(workload)
    b = b0 * batch
    return base if b == 1 else f"{base}-b{b}"


@dataclasses.dataclass(frozen=True)
class WarmReport:
    """What one ``warm()`` pass touched."""
    entries: Tuple[str, ...]          # canonical names now resident
    keys: Tuple[str, ...]             # their content hashes
    searched: int                     # grid points that missed on disk
    worker_failed: int = 0            # pool workers that died (recovered)


@dataclasses.dataclass(frozen=True)
class LookupResult:
    """One served request: the schedule plus which ladder rung answered.

    ``outcome`` is one of ``"mem"``, ``"disk"``, ``"searched"``,
    ``"nearest_batch"``, ``"heuristic"``; ``degraded`` is True for the
    last two (the schedule is servable but not the searched optimum for
    this exact request).  ``attempts`` counts cold-search tries spent;
    ``error`` carries the last search failure when the ladder had to
    degrade past rung 3."""
    schedule: object
    workload: str                  # canonical name
    key: str                       # content hash of the request
    batch: int                     # absolute batch requested
    outcome: str
    degraded: bool
    attempts: int = 0
    error: str = ""


def _warm_worker(args):
    """Process-pool worker: resolve + cached-search one grid point
    (module-level so it pickles under spawn).  Returns the canonical
    name, its key, and the worker's cache counters so the caller can
    fold them into its own tracer.  ``crash`` simulates the worker
    dying before any useful work (chaos: the parent must recover)."""
    name, hw, cache_dir, tile_mode, spatial_mode, crash = args
    if crash:
        raise chaos_mod.InjectedFault("worker_crash")
    layers = get_workload(name)
    with obs.tracing() as tr:
        cached_search(layers, hw, workload=name, cache_dir=cache_dir,
                      tile_mode=tile_mode, spatial_mode=spatial_mode)
    key = schedule_key(layers, hw, tile_mode=tile_mode,
                       spatial_mode=spatial_mode)
    return name, key, dict(tr.counters)


def heuristic_schedule(layers: Sequence[Layer],
                       hw: Optional[HWSpec] = None, *,
                       workload: str = "custom",
                       tile_mode: str = "full",
                       spatial_mode: str = "factored"):
    """The last rung of the degradation ladder: an untiled per-layer
    schedule derived without the fusion DP or the tile search.

    Every MAC layer gets its min-cycle spatial mapping and min-energy
    loop order/placements (both single-layer scans, milliseconds for a
    whole network); every layer is its own group — no fusion, no
    co-tiling, no lowering params — so nothing here can hit the search
    paths a fault just took down.  The result is a complete, costed,
    servable ``Schedule``; it is strictly worse than the searched one
    (fusion savings forfeited) and is flagged so callers can tell."""
    from repro_torch.core.costmodel import scan_state_level
    from repro_torch.core.workload import MAC_OPS, SCAN, scan_state_bytes
    from repro_torch.search import cache as cache_mod
    from repro_torch.search import mapper
    from repro_torch.search.auto import (SCAN_CHUNK_DEFAULT, Schedule,
                                         evaluate_schedule)
    hw = hw or HWSpec()
    layers = list(layers)
    mappings: Dict[str, Tuple] = {}
    cycles: Dict[str, int] = {}
    orders: Dict[str, Tuple[str, ...]] = {}
    placements: Dict[str, Dict[str, str]] = {}
    tiles: Dict[str, Dict[str, int]] = {}
    util_sum, util_n = 0.0, 0
    for l in layers:
        if l.op == SCAN:
            mc = mapper.best_scan_mapping(l, hw.rows, hw.cols,
                                          chunk=SCAN_CHUNK_DEFAULT,
                                          spatial_mode=spatial_mode)
            mappings[l.name] = mc.mapping
            cycles[l.name] = mc.cycles
            lvl = scan_state_level(l, hw).name
            tiles[l.name] = {"chunk": SCAN_CHUNK_DEFAULT,
                             "state_bytes": scan_state_bytes(l),
                             "level": lvl}
            placements[l.name] = {"state": lvl}
            util_sum += mc.utilization
            util_n += 1
            continue
        if l.op not in MAC_OPS:
            continue
        mc = mapper.best_mapping(l, hw.rows, hw.cols,
                                 spatial_mode=spatial_mode)
        mappings[l.name] = mc.mapping
        cycles[l.name] = mc.cycles
        util_sum += mc.utilization
        util_n += 1
        t = mapper.best_temporal(l, hw, tile_mode=tile_mode)
        if t is not None:
            orders[l.name] = t.order
            placements[l.name] = dict(t.placement)
    hw_doc = {"rows": hw.rows, "cols": hw.cols, "clock_hz": hw.clock_hz,
              "bits": hw.bits, "e_mac": hw.e_mac,
              "static_mw": hw.static_mw,
              "hierarchy": hw.hierarchy.to_json()}
    sched = Schedule(
        version=cache_mod.SEARCH_VERSION, workload=workload,
        key=cache_mod.schedule_key(layers, hw, tile_mode=tile_mode,
                                   spatial_mode=spatial_mode),
        hw=hw_doc, mappings=mappings, orders=orders,
        fused_nonlinear=(), groups=tuple((l.name,) for l in layers),
        edges=(), tiles=tiles, lowered={}, cost={},
        tile_mode=tile_mode, spatial_mode=spatial_mode,
        placements=placements)
    nc = evaluate_schedule(layers, sched, hw, cycles=cycles)
    lat, en = nc.latency_s, nc.energy_j
    sched.cost = {"latency_s": lat, "energy_j": en, "edp": en * lat,
                  "fps": 1.0 / lat, "dram_bytes": float(nc.dram_bytes()),
                  "spatial_util": util_sum / util_n if util_n else 0.0}
    sched.degraded = "heuristic"
    return sched


class ServeStore:
    """Warm schedule store over one cache directory + HWSpec.

    ``retry_attempts`` / ``retry_backoff_s`` shape the cold-search
    retry envelope (exponential backoff between attempts);
    ``search_deadline_s`` is the default per-request budget the
    envelope honors (None: unbounded); ``stale_s`` overrides the claim
    staleness window of ``search.cache`` per store (None: the
    ``REPRO_CLAIM_STALE_S`` env / built-in default); ``verify`` runs
    the ``repro_torch.check`` static verifier (with the Hopper launch
    lint) over every disk replay before serving it — a replayed
    artifact with findings is treated as a miss and re-searched
    (counters ``check.pass`` / ``check.fail``).
    Memory hits are not re-verified: the memory tier only ever holds
    schedules that entered through a verified (or searched) path."""

    def __init__(self, cache_dir, hw: Optional[HWSpec] = None, *,
                 tile_mode: str = "full",
                 spatial_mode: str = "factored",
                 retry_attempts: int = 3,
                 retry_backoff_s: float = 0.05,
                 search_deadline_s: Optional[float] = None,
                 stale_s: Optional[float] = None,
                 verify: bool = False) -> None:
        self.cache_dir = Path(cache_dir)
        self.hw = hw or HWSpec()
        self.tile_mode = tile_mode
        self.spatial_mode = spatial_mode
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_s = retry_backoff_s
        self.search_deadline_s = search_deadline_s
        self.stale_s = stale_s
        self.verify = bool(verify)
        self._mem: Dict[str, object] = {}           # key -> Schedule
        # (canonical name) -> (layers, key): resolved once per endpoint
        self._resolved: Dict[str, Tuple[List[Layer], str]] = {}
        # base name -> absolute batch levels ever requested (rung 4
        # scans these plus BATCH_LEVELS for a servable neighbor)
        self._known_batches: Dict[str, Set[int]] = {}
        # degraded fallbacks are memoized separately: they must never
        # shadow the real cache tiers once the fault clears
        self._fallback: Dict[str, object] = {}

    # -- request resolution -------------------------------------------

    def resolve(self, workload: str, batch: int = 1
                ) -> Tuple[str, List[Layer], str]:
        """(canonical name, layer list, content key) of one request."""
        name = canonical_name(workload, batch)
        hit = self._resolved.get(name)
        if hit is None:
            layers = get_workload(name)
            key = schedule_key(layers, self.hw, tile_mode=self.tile_mode,
                               spatial_mode=self.spatial_mode)
            hit = self._resolved[name] = (layers, key)
            base, b_abs = parse_workload(name)
            self._known_batches.setdefault(base, set()).add(b_abs)
        return name, hit[0], hit[1]

    def key_for(self, workload: str, batch: int = 1) -> str:
        return self.resolve(workload, batch)[2]

    def artifact_path(self, workload: str, batch: int = 1) -> Path:
        name, _, key = self.resolve(workload, batch)
        return self.cache_dir / artifact_name(name, key)

    def evict(self, workload: str, batch: int = 1) -> bool:
        """Drop one request from the memory tier (process-restart
        analogue; chaos uses it so file faults become visible)."""
        key = self.key_for(workload, batch)
        self._fallback.pop(key, None)
        return self._mem.pop(key, None) is not None

    def _replay_ok(self, layers: List[Layer], sched, name: str) -> bool:
        """Gate one disk replay through the static verifier when the
        store was built with ``verify=True``."""
        if not self.verify:
            return True
        from repro_torch.check import verify_schedule
        findings = verify_schedule(layers, sched, source="serve")
        if findings:
            obs.event("serve.lookup", workload=name,
                      outcome="verify_fail", n=len(findings),
                      first=str(findings[0]))
            return False
        return True

    # -- the retry envelope -------------------------------------------

    def _search_with_retry(self, layers: List[Layer], name: str,
                           deadline_s: Optional[float],
                           refresh: bool = False) -> Tuple[object, int]:
        """One cold search under the deadline + exponential-backoff
        retry envelope.  Returns (schedule, attempts); raises the last
        failure (or ``DeadlineExceeded``) once the budget is spent —
        the ladder degrades from there, the caller never sees a stall.
        ``refresh`` forces the artifact store (set when a verify-fail
        proved the on-disk artifact bad: the repaired schedule must
        overwrite it, not defer to it)."""
        t0 = time.monotonic()
        attempts = 0
        last: Optional[BaseException] = None
        for i in range(self.retry_attempts):
            if deadline_s is not None and \
                    time.monotonic() - t0 >= deadline_s:
                obs.count("serve.retry.deadline_exceeded")
                obs.event("serve.retry", workload=name,
                          outcome="deadline", attempts=attempts,
                          deadline_s=deadline_s)
                raise DeadlineExceeded(
                    f"cold search for {name} exceeded "
                    f"{deadline_s:g}s after {attempts} attempts"
                ) from last
            attempts += 1
            obs.count("serve.retry.attempt")
            try:
                chaos_mod.on_search_attempt()
                sched = cached_search(
                    layers, self.hw, workload=name,
                    cache_dir=self.cache_dir, tile_mode=self.tile_mode,
                    spatial_mode=self.spatial_mode, replay=False,
                    stale_s=self.stale_s, refresh=refresh)
                if i:
                    obs.count("serve.retry.recovered")
                return sched, attempts
            except Exception as e:          # noqa: BLE001 — the envelope
                last = e                     # exists to absorb failures
                obs.count("serve.retry.failure")
                obs.event("serve.retry", workload=name, outcome="failure",
                          attempt=attempts,
                          error=f"{type(e).__name__}: {e}")
                if i + 1 < self.retry_attempts:
                    pause = self.retry_backoff_s * (2 ** i)
                    if deadline_s is not None:
                        pause = min(pause, max(
                            0.0, deadline_s - (time.monotonic() - t0)))
                    if pause > 0:
                        time.sleep(pause)
        assert last is not None
        raise last

    # -- the degradation ladder ---------------------------------------

    def _nearest_batch(self, base: str, b_abs: int
                       ) -> Optional[Tuple[object, int]]:
        """Rung 4: the nearest co-searched batch level of the same base
        workload that is servable *without* a search — memory first,
        then a disk replay.  Nearness is the batch ratio (log scale:
        serving b=16 off b=4 and off b=64 are equally wrong), smaller
        level preferred on ties (padding a short batch up beats
        splitting a long one more often than not)."""
        import math
        cands = (self._known_batches.get(base, set()) |
                 set(BATCH_LEVELS)) - {b_abs}
        for cb in sorted(cands,
                         key=lambda c: (abs(math.log(c / b_abs)), c)):
            cname = base if cb == 1 else f"{base}-b{cb}"
            try:
                _, clayers, ckey = self.resolve(cname, 1)
            except KeyError:               # unregistered base/variant
                continue
            sched = self._mem.get(ckey)
            if sched is None:
                sched, _ = try_replay(
                    self.cache_dir / artifact_name(cname, ckey), clayers,
                    ckey, workload=cname)
                if sched is not None:
                    self._mem[ckey] = sched
            if sched is not None:
                return sched, cb
        return None

    def _rescale(self, sched, name: str, key: str, ratio: float):
        """A neighbor-level schedule rescaled to the requested batch:
        the cost model is linear in batch (compute-bound array), so
        latency/energy/traffic scale by the batch ratio and EDP by its
        square.  The mapping/tiling structure is the neighbor's — close,
        not optimal — which is exactly what ``degraded`` flags."""
        scale = {"latency_s": ratio, "energy_j": ratio,
                 "edp": ratio * ratio, "fps": 1.0 / ratio,
                 "dram_bytes": ratio, "energy_tiled_j": ratio,
                 "edp_tiled": ratio * ratio, "sram_tiled_bytes": ratio}
        cost = {k: v * scale.get(k, 1.0) for k, v in sched.cost.items()}
        out = dataclasses.replace(sched, workload=name, key=key,
                                  cost=cost)
        out.degraded = "nearest_batch"
        return out

    def request(self, workload: str, batch: int = 1, *,
                deadline_s=_UNSET) -> LookupResult:
        """Serve one ``(workload, batch)`` request through the full
        degradation ladder (see the module docstring).  Always returns
        a ``LookupResult`` whose ``schedule`` is servable — never None,
        never an unbounded stall (``deadline_s`` caps the cold-search
        envelope; default is the store's ``search_deadline_s``)."""
        name, layers, key = self.resolve(workload, batch)
        base, b_abs = parse_workload(name)
        # rung 1: memory
        sched = self._mem.get(key)
        if sched is not None:
            obs.count("cache.hit")
            obs.count("serve.store.mem_hit")
            obs.event("serve.lookup", workload=name, key=key,
                      outcome="mem_hit")
            return LookupResult(sched, name, key, b_abs, "mem", False)
        # rung 2: disk replay (artifact parse + remap, no DP)
        sched, _why = try_replay(self.cache_dir / artifact_name(name, key),
                                 layers, key, workload=name)
        bad_replay = False
        if sched is not None:
            if self._replay_ok(layers, sched, name):
                self._mem[key] = sched
                obs.event("serve.lookup", workload=name, key=key,
                          outcome="disk_hit")
                return LookupResult(sched, name, key, b_abs, "disk",
                                    False)
            bad_replay = True
        # rung 3: cold search under the retry + deadline envelope
        budget = self.search_deadline_s if deadline_s is _UNSET \
            else deadline_s
        err = ""
        attempts = 0
        try:
            sched, attempts = self._search_with_retry(layers, name,
                                                      budget,
                                                      refresh=bad_replay)
            self._mem[key] = sched
            obs.event("serve.lookup", workload=name, key=key,
                      outcome="searched", attempts=attempts)
            return LookupResult(sched, name, key, b_abs, "searched",
                                False, attempts)
        except Exception as e:             # noqa: BLE001 — degrade, never
            err = f"{type(e).__name__}: {e}"  # propagate to the caller
            obs.count("serve.degrade.search_failed")
            obs.event("serve.degrade", workload=name, key=key,
                      error=err)
        # rung 4: nearest co-searched batch level, cost-rescaled
        alt = self._nearest_batch(base, b_abs)
        if alt is not None:
            neighbor, cb = alt
            out = self._rescale(neighbor, name, key, b_abs / cb)
            obs.count("serve.degrade.nearest_batch")
            obs.event("serve.lookup", workload=name, key=key,
                      outcome="nearest_batch", from_batch=cb,
                      to_batch=b_abs)
            return LookupResult(out, name, key, b_abs, "nearest_batch",
                                True, attempts, err)
        # rung 5: the untiled heuristic — cannot fail
        sched = self._fallback.get(key)
        if sched is None:
            sched = heuristic_schedule(layers, self.hw, workload=name,
                                       tile_mode=self.tile_mode,
                                       spatial_mode=self.spatial_mode)
            self._fallback[key] = sched
        obs.count("serve.degrade.heuristic")
        obs.event("serve.lookup", workload=name, key=key,
                  outcome="heuristic")
        return LookupResult(sched, name, key, b_abs, "heuristic", True,
                            attempts, err)

    # -- lookups ------------------------------------------------------

    def lookup(self, workload: str, batch: int = 1):
        """Serve one ``(workload, batch)`` request; the Schedule half of
        ``request`` (which see).  Always returns a servable Schedule —
        degraded answers carry a ``degraded`` attribute."""
        return self.request(workload, batch).schedule

    def lookup_layers(self, layers: Sequence[Layer], *,
                      workload: str = "custom"):
        """Same serving ladder for an unregistered layer chain (the
        content hash, not the name, is the identity).  No batch family
        to degrade onto, so the ladder is mem -> disk -> retried search
        -> heuristic."""
        layers = list(layers)
        key = schedule_key(layers, self.hw, tile_mode=self.tile_mode,
                           spatial_mode=self.spatial_mode)
        sched = self._mem.get(key)
        if sched is not None:
            obs.count("cache.hit")
            obs.count("serve.store.mem_hit")
            return sched
        sched, _why = try_replay(
            self.cache_dir / artifact_name(workload, key), layers, key,
            workload=workload)
        bad_replay = False
        if sched is not None:
            if self._replay_ok(layers, sched, workload):
                self._mem[key] = sched
                return sched
            bad_replay = True
        try:
            sched, _ = self._search_with_retry(layers, workload,
                                               self.search_deadline_s,
                                               refresh=bad_replay)
            self._mem[key] = sched
            return sched
        except Exception as e:             # noqa: BLE001
            obs.count("serve.degrade.search_failed")
            obs.event("serve.degrade", workload=workload, key=key,
                      error=f"{type(e).__name__}: {e}")
        fallback = self._fallback.get(key)
        if fallback is None:
            fallback = heuristic_schedule(
                layers, self.hw, workload=workload,
                tile_mode=self.tile_mode, spatial_mode=self.spatial_mode)
            self._fallback[key] = fallback
        obs.count("serve.degrade.heuristic")
        return fallback

    def resident(self, workload: str, batch: int = 1) -> bool:
        return self.key_for(workload, batch) in self._mem

    def __len__(self) -> int:
        return len(self._mem)

    # -- warming ------------------------------------------------------

    def warm(self, workloads: Sequence[str], *,
             batches: Sequence[int] = BATCH_LEVELS,
             jobs: int = 0) -> WarmReport:
        """Pre-search the (workload x batch) grid and fault every
        schedule into memory.

        Grid points collapsing onto one content key (e.g. a workload
        listed both bare and with a ``-b<N>`` suffix) are deduplicated
        before the fan-out, so each unique key is searched — and, via
        the per-key store claim, stored — exactly once.  ``jobs > 1``
        fans the cold searches out over a spawned process pool (the
        caller may hold a CUDA context or torch's threads, which a fork
        would copy; a worker imports the search afresh and touches no
        card, and the chaos monkey reaches it only as ``_warm_worker``'s
        crash flag); the workers' ``cache.*`` counters are folded back
        into the caller's tracer (the span analogue of ``PerfRecorder.merge``).  A worker that
        dies mid-grid (crash, OOM kill, injected fault) is counted
        (``serve.warm.worker_failed``) and its grid point recovered by
        the parent's serial faulting pass — a crashed worker can delay
        a warm, never fail it."""
        grid: Dict[str, str] = {}                   # key -> canonical name
        for wl in workloads:
            for b in batches:
                name, _, key = self.resolve(wl, b)
                grid.setdefault(key, name)
        todo = {k: n for k, n in grid.items() if k not in self._mem}
        worker_failed = 0
        with obs.span("serve.warm", entries=len(grid), jobs=jobs,
                      todo=len(todo)):
            searched = 0
            if jobs > 1 and todo:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                monkey = chaos_mod.current()
                work = [(n, self.hw, self.cache_dir, self.tile_mode,
                         self.spatial_mode,
                         monkey.should("worker_crash") if monkey
                         else False)
                        for n in todo.values()]
                ctx = multiprocessing.get_context("spawn")
                with ProcessPoolExecutor(max_workers=jobs,
                                         mp_context=ctx) as ex:
                    futures = [ex.submit(_warm_worker, a) for a in work]
                    for fut in futures:
                        try:
                            _, _, counters = fut.result()
                        except Exception as e:     # noqa: BLE001 — a dead
                            worker_failed += 1      # worker must not kill
                            obs.count("serve.warm.worker_failed")
                            obs.event("serve.warm.worker_failed",
                                      error=f"{type(e).__name__}: {e}")
                            continue
                        searched += counters.get("cache.miss", 0)
                        for ck, cv in counters.items():
                            obs.count(ck, cv)
            # fault everything into memory through the serving path
            # (serial warm does its cold searches right here, including
            # any grid point a crashed pool worker left behind)
            for key, name in grid.items():
                if key in self._mem:
                    continue
                if not (self.cache_dir / artifact_name(name, key)).exists():
                    searched += 1
                self.lookup(name)
        return WarmReport(entries=tuple(grid.values()),
                          keys=tuple(grid.keys()), searched=searched,
                          worker_failed=worker_failed)
