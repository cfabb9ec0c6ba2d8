"""The auto-scheduler: mapping + loop order + fusion + tiles, end to end.

``auto_schedule`` derives a full per-layer schedule from enumeration
alone — no IBN annotations, no reconfigurable/fusion flags:

  1. spatial mapping per MAC layer   (mapper: ~42-point space/layer)
  2. fusion partition over the chain (partition: DP over groups)
  3. tiles per depth-first group     (tiler: budget-driven)
  4. temporal loop order per layer   (mapper: pixelwise-constrained
     where a channel-stat nonlinear fused into the layer's writeback)
  5. Hopper launch parameters        (lower)
  6. headline cost via ``costmodel.cost_network_scheduled`` — the same
     traffic accounting the hand-coded Fig 8 stack uses, so searched
     and hand-coded schedules are directly comparable.

The result is a JSON-serializable ``Schedule`` (see ``cache``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.costmodel import (HWSpec, NetworkCost, _scan_layer_cost,
                                  cost_network_scheduled,
                                  group_sram_overrides, scan_state_level)
from repro_torch.core.workload import (MAC_OPS, NORM, SCAN, SOFTMAX, Layer,
                                 scan_state_bytes)
from repro_torch.search import cache as cache_mod
from repro_torch.search import lower as lower_mod
from repro_torch.search import mapper, partition
from repro_torch.search.memo import SearchMemo
from repro_torch.search.perf import PerfRecorder


@dataclasses.dataclass
class Schedule:
    """A complete searched schedule (JSON-serializable).  ``hw`` embeds
    the full memory hierarchy (nested ``levels`` list), and
    ``placements`` records, per MAC layer, the memory level each
    operand's stationary tile was placed at by the mapper.

    A mapping value is a (row_dim, col_dim) pair, or — when the
    factored search strictly beat every pair on that layer — the
    factored per-axis form ``((dim, factor), ...)`` per axis."""
    version: int
    workload: str
    key: str                                       # content hash
    hw: Dict[str, object]
    mappings: Dict[str, Tuple]                     # MAC layer -> mapping
    orders: Dict[str, Tuple[str, ...]]             # MAC layer -> loop order
    fused_nonlinear: Tuple[str, ...]
    groups: Tuple[Tuple[str, ...], ...]            # layer names per group
    edges: Tuple[Tuple[int, int, int], ...]        # (producer, consumer, B)
    tiles: Dict[str, Dict[str, int]]               # group head -> tile
    lowered: Dict[str, Dict]                       # kernel -> params
    cost: Dict[str, float]
    # columns hard-wired as an adder tree (non-reconfigurable array):
    # the mappings must be costed with the column-void penalty
    fixed_wiring: bool = False
    # the tile-candidate space this schedule was searched in ("full" |
    # "legacy" | "pow2") — part of the content hash so ablation
    # schedules are never replayed as full-enumeration results
    tile_mode: str = "full"
    # the spatial mapspace ("factored" | "pair") — same hashing rule:
    # a pair-only ablation schedule is a different search problem
    spatial_mode: str = "factored"
    # MAC layer -> {operand: memory-level name} loop placements
    placements: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)

    def spill_edge_list(self):
        from repro_torch.core.fusion import SpillEdge
        return [SpillEdge(producer=p, consumer=c, nbytes=b, is_ibn=False)
                for p, c, b in self.edges]


def evaluate_schedule(layers: List[Layer], schedule: Schedule,
                      hw: Optional[HWSpec] = None, *,
                      tile_aware: bool = False,
                      cycles: Optional[Dict[str, int]] = None,
                      dedup: bool = True,
                      cost_cache: Optional[Dict] = None) -> NetworkCost:
    """Cost a Schedule with the shared zigzag-lite accounting.

    ``tile_aware=True`` swaps the flat per-layer SRAM estimate of each
    multi-MAC fusion group for the tiler's ragged-edge accounting
    (input re-reads per channel round, weight re-streams per x slab) —
    the metric under which tile-candidate spaces are compared.  The
    default keeps the seed accounting so searched and hand-coded
    schedules stay directly comparable.

    The schedule's per-operand loop placements feed the per-level
    traffic rows: each operand's streaming is charged to the level its
    searched stationarity makes the transfer cross (on the paper's
    3-level design this reproduces the lumped stream-level row
    bit-exactly; deeper hierarchies split the rows the way the mapper
    ranked them).
    """
    from repro_torch.core import dataflow
    hw = hw or HWSpec()
    overrides = group_sram_overrides(layers, schedule.groups,
                                     schedule.tiles) if tile_aware else None
    # a SCAN layer's tiles entry records the searched chunk length — the
    # evaluation must price the scan at exactly that chunk
    scan_chunks = {name: int(t["chunk"])
                   for name, t in schedule.tiles.items() if "chunk" in t}
    return cost_network_scheduled(
        layers, hw,
        mappings={k: dataflow.as_mapping(v)
                  for k, v in schedule.mappings.items()},
        fused_nonlinear=set(schedule.fused_nonlinear),
        edges=schedule.spill_edge_list(),
        fixed_wiring=schedule.fixed_wiring,
        sram_overrides=overrides,
        placements=schedule.placements,
        cycles=cycles, scan_chunks=scan_chunks or None,
        dedup=dedup, cost_cache=cost_cache)


def auto_schedule(layers: List[Layer], hw: Optional[HWSpec] = None, *,
                  workload: str = "custom",
                  reconfigurable: bool = True,
                  tile_mode: str = "full",
                  spatial_mode: str = "factored",
                  dedup: bool = True,
                  memo: Optional["SearchMemo"] = None,
                  perf: Optional[PerfRecorder] = None) -> Schedule:
    """Search mappings, loop orders, fusion groups, and tiles for one
    workload on one HWSpec.  ``reconfigurable=False`` restricts the
    whole network to a single fixed-wiring mapping (the paper's baseline
    array) — the search then optimizes only what that array allows.
    ``tile_mode`` selects the tile-candidate space: "full" (divisors +
    imperfect factors, the default) or "pow2" (the ablation baseline the
    ragged-aware search is measured against).  ``spatial_mode`` selects
    the spatial mapspace: "factored" (per-axis factored unrollings with
    row/col replication, the default) or "pair" (the ordered-dim-pair
    ablation — bit-identical to the pre-factored search).

    ``dedup=True`` (default) routes every per-layer / per-group
    subproblem through a unique-signature memo (``search.memo``) and the
    pruned temporal enumeration, solving each *unique* layer shape once
    and fanning the result back out; ``dedup=False`` is the brute-force
    equivalence mode — no memo, full enumeration — which must produce a
    bit-identical Schedule (pinned in ``tests/test_search_perf.py``) and
    is the baseline the ``search.perf.*`` speedup rows measure against.
    Pass a shared ``memo`` to reuse tables across the calls of a DSE
    sweep; pass ``perf`` (a ``search.perf.PerfRecorder``) to collect
    per-phase wall times and memo hit rates.

    When an ``obs`` tracer is active (``obs.tracing()``, the CLI's
    ``--trace``) the whole call nests under an ``auto`` span with the
    per-phase spans and decision-provenance counters of the mapper /
    partitioner / tiler / lowerer inside it; with no active tracer
    every hook is a no-op and the schedule is bit-identical.
    """
    with obs.span("auto", workload=workload, layers=len(layers),
                  tile_mode=tile_mode, spatial_mode=spatial_mode,
                  dedup=dedup):
        return _auto_schedule(layers, hw, workload=workload,
                              reconfigurable=reconfigurable,
                              tile_mode=tile_mode,
                              spatial_mode=spatial_mode, dedup=dedup,
                              memo=memo, perf=perf)


SCAN_CHUNK_DEFAULT = 64            # the RWKV kernel's fixed baseline
_SCAN_CHUNK_CANDIDATES = (8, 16, 32, 64, 128, 256)


def _scan_chunk_menu(scan_layers: List[Layer]) -> List[int]:
    t_max = max(l.ox for l in scan_layers)
    return sorted({c for c in _SCAN_CHUNK_CANDIDATES if c <= t_max}
                  | {SCAN_CHUNK_DEFAULT})


def _scan_swap_terms(scan_layers: List[Layer], hw: HWSpec, chunk: int, *,
                     spatial_mode: str, fixed_wiring: bool,
                     memo) -> Tuple[int, float]:
    """(cycles, non-static pJ) all scan layers contribute at ``chunk``
    under their best mappings — the terms the analytic chunk selection
    swaps in and out of the reference network totals."""
    cyc_tot, pj_tot = 0, 0.0
    for l in scan_layers:
        mc = mapper.best_scan_mapping(l, hw.rows, hw.cols, chunk=chunk,
                                      spatial_mode=spatial_mode,
                                      fixed_wiring=fixed_wiring,
                                      memo=memo)
        lc = _scan_layer_cost(l, hw, mc.mapping, chunk,
                              fixed_wiring=fixed_wiring, cyc=mc.cycles)
        cyc_tot += lc.total_cycles
        pj_tot += sum(lc.energy_pj(hw).values())
    return cyc_tot, pj_tot


def _best_scan_chunk(layers: List[Layer], ref: Schedule, hw: HWSpec, *,
                     spatial_mode: str, fixed_wiring: bool,
                     memo) -> int:
    """Network-EDP argmin over the chunk menu, by analytically swapping
    the scan layers' (cycles, energy) at each candidate into the
    reference (chunk=64) totals.  Exact up to float re-association: the
    partition structure is chunk-independent (the state bytes gating
    fusion legality are chunk-free, and a scan never co-tiles with
    other compute), so only the scan layers' own terms move — the
    winner is re-searched end to end and compared exactly afterwards.
    """
    scan_layers = [l for l in layers if l.op == SCAN]
    ref_cyc, ref_pj = _scan_swap_terms(scan_layers, hw,
                                       SCAN_CHUNK_DEFAULT,
                                       spatial_mode=spatial_mode,
                                       fixed_wiring=fixed_wiring,
                                       memo=memo)
    base_cycles = ref.cost["latency_s"] * hw.clock_hz - ref_cyc
    static_pj_s = hw.static_mw * 1e-3 * 1e12       # pJ per second
    base_pj = (ref.cost["energy_j"] * 1e12
               - static_pj_s * ref.cost["latency_s"] - ref_pj)
    best_chunk, best_edp = SCAN_CHUNK_DEFAULT, None
    for chunk in _scan_chunk_menu(scan_layers):
        cyc, pj = _scan_swap_terms(scan_layers, hw, chunk,
                                   spatial_mode=spatial_mode,
                                   fixed_wiring=fixed_wiring, memo=memo)
        lat = (base_cycles + cyc) / hw.clock_hz
        en = (base_pj + pj + static_pj_s * lat) * 1e-12
        edp = en * lat
        if best_edp is None or edp < best_edp or \
                (edp == best_edp and chunk == SCAN_CHUNK_DEFAULT):
            best_chunk, best_edp = chunk, edp
    obs.event("auto.scan_chunk", chunk=best_chunk,
              menu=_scan_chunk_menu(scan_layers))
    return best_chunk


def _auto_schedule(layers: List[Layer], hw: Optional[HWSpec], *,
                   workload: str, reconfigurable: bool, tile_mode: str,
                   spatial_mode: str, dedup: bool,
                   memo: Optional["SearchMemo"],
                   perf: Optional[PerfRecorder],
                   scan_chunk: Optional[int] = None) -> Schedule:
    hw = hw or HWSpec()
    scan_layers = [l for l in layers if l.op == SCAN]
    if scan_layers and scan_chunk is None:
        # two-pass network-level chunk selection: search at the fixed
        # baseline chunk, analytically rank the menu, re-search the
        # winner, and keep whichever full evaluation is actually best —
        # the searched schedule is ≤ the chunk=64 baseline by
        # construction
        ref = _auto_schedule(layers, hw, workload=workload,
                             reconfigurable=reconfigurable,
                             tile_mode=tile_mode,
                             spatial_mode=spatial_mode, dedup=dedup,
                             memo=memo, perf=perf,
                             scan_chunk=SCAN_CHUNK_DEFAULT)
        pick_memo = memo if dedup else None
        best = _best_scan_chunk(layers, ref, hw,
                                spatial_mode=spatial_mode,
                                fixed_wiring=not reconfigurable,
                                memo=pick_memo)
        if best == SCAN_CHUNK_DEFAULT:
            return ref
        won = _auto_schedule(layers, hw, workload=workload,
                             reconfigurable=reconfigurable,
                             tile_mode=tile_mode,
                             spatial_mode=spatial_mode, dedup=dedup,
                             memo=memo, perf=perf, scan_chunk=best)
        return won if won.cost["edp"] <= ref.cost["edp"] else ref
    if not dedup and memo is not None:
        raise ValueError("dedup=False is the brute-force equivalence "
                         "mode — a memo would partially accelerate the "
                         "baseline; pass one or the other")
    if memo is None and dedup:
        memo = SearchMemo(perf=perf)
    elif memo is not None and perf is not None:
        # caller supplied both: route the shared memo's hit/miss
        # counters to this call's recorder instead of the memo's
        # private default (which nobody reads)
        memo.perf = perf
    if perf is None:
        perf = memo.perf if memo is not None else PerfRecorder()

    # 1. spatial mappings
    with perf.phase("spatial"):
        mappings: Dict[str, Tuple] = {}
        cycles_by_name: Dict[str, int] = {}
        util_sum, util_n = 0.0, 0
        fixed = None if reconfigurable else \
            mapper.best_fixed_mapping(layers, hw.rows, hw.cols)
        for l in layers:
            if l.op == SCAN:
                mc = mapper.best_scan_mapping(
                    l, hw.rows, hw.cols, chunk=scan_chunk,
                    fixed_wiring=not reconfigurable,
                    spatial_mode=spatial_mode, memo=memo)
                mappings[l.name] = mc.mapping
                cycles_by_name[l.name] = mc.cycles
                util_sum += mc.utilization
                util_n += 1
                continue
            if l.op not in MAC_OPS:
                continue
            if fixed is not None:
                from repro_torch.core import dataflow
                mappings[l.name] = fixed
                cyc = dataflow.cycles_generic(
                    l, fixed, hw.rows, hw.cols, fixed_wiring=True)
                cycles_by_name[l.name] = cyc
                util_sum += l.macs / (cyc * hw.rows * hw.cols)
            else:
                mc = mapper.best_mapping(l, hw.rows, hw.cols, memo=memo,
                                         spatial_mode=spatial_mode)
                mappings[l.name] = mc.mapping
                cycles_by_name[l.name] = mc.cycles
                util_sum += mc.utilization
            util_n += 1

    # 2. fusion partition (DP)
    scan_chunks = {l.name: scan_chunk for l in scan_layers} \
        if scan_layers else None
    with perf.phase("partition"):
        part = partition.partition_chain(layers, cycles_by_name, hw,
                                         tile_mode=tile_mode,
                                         scan_chunks=scan_chunks,
                                         memo=memo)

    # 3. tiles + group summaries
    with obs.span("tiles", groups=len(part.groups)):
        tiles: Dict[str, Dict[str, int]] = {}
        group_names: List[Tuple[str, ...]] = []
        for g in part.groups:
            sl = layers[g.start:g.end]
            group_names.append(tuple(l.name for l in sl))
            for l in sl:
                if l.op == SCAN:
                    # the searched chunk is the scan's "tile": recorded
                    # here (not as a Schedule field) so the cache format
                    # and evaluation replay carry it unchanged
                    tiles[l.name] = {
                        "chunk": scan_chunk,
                        "state_bytes": scan_state_bytes(l),
                        "level": scan_state_level(l, hw).name}
            macs = [l for l in sl if l.op in MAC_OPS]
            if g.tile is not None and macs:
                tiles[macs[0].name] = {
                    "tile_x": g.tile.tile_x, "tile_c": g.tile.tile_c,
                    "buffer_bytes": g.tile.buffer_bytes,
                    "weight_rereads": g.tile.weight_rereads,
                    "sram_traffic": g.tile.sram_traffic,
                    "ragged_x": g.tile.ragged_x,
                    "ragged_c": g.tile.ragged_c,
                    "level": g.tile.level}

    # 4. temporal orders (pixelwise-constrained where a channel-stat
    #    nonlinear fused into this layer's writeback) + per-operand
    #    stationarity placements over the memory hierarchy
    brute = not dedup
    with perf.phase("temporal"):
        orders: Dict[str, Tuple[str, ...]] = {}
        placements: Dict[str, Dict[str, str]] = {}
        fused_set = set(part.fused_nonlinear)
        for g in part.groups:
            sl = layers[g.start:g.end]
            last_mac: Optional[Layer] = None
            needs_pixelwise: Dict[str, bool] = {}
            for l in sl:
                if l.op in MAC_OPS:
                    last_mac = l
                    needs_pixelwise.setdefault(l.name, False)
                elif (l.op in (NORM, SOFTMAX) and l.name in fused_set
                      and last_mac is not None):
                    needs_pixelwise[last_mac.name] = True
            for l in sl:
                if l.op == SCAN:
                    # the chunk loop's order is forced by the carry; the
                    # one placement decision is where the state resides
                    placements[l.name] = {
                        "state": scan_state_level(l, hw).name}
                    continue
                if l.op not in MAC_OPS:
                    continue
                t = mapper.best_temporal(
                    l, hw,
                    require_pixelwise=needs_pixelwise.get(l.name, False),
                    tile_mode=tile_mode, memo=memo, brute=brute)
                if t is None:
                    t = mapper.best_temporal(l, hw, tile_mode=tile_mode,
                                             memo=memo, brute=brute)
                if t is not None:
                    orders[l.name] = t.order
                    placements[l.name] = dict(t.placement)

    # 5. launch parameters of the Hopper kernels
    with perf.phase("lower"):
        lowered = {
            " + ".join(lk.layer_names): {"kernel": lk.kernel, **lk.params,
                                         "ragged": dict(lk.ragged)}
            for lk in lower_mod.lower_schedule(list(layers), part.groups,
                                               tiles)}

    # same document dataclasses.asdict would build, minus walking the
    # nested hierarchy twice (it is replaced by its JSON form anyway)
    hw_doc = {"rows": hw.rows, "cols": hw.cols, "clock_hz": hw.clock_hz,
              "bits": hw.bits, "e_mac": hw.e_mac,
              "static_mw": hw.static_mw,
              "hierarchy": hw.hierarchy.to_json()}
    with perf.phase("key"):
        key = cache_mod.schedule_key(layers, hw, tile_mode, spatial_mode)
    sched = Schedule(
        version=cache_mod.SEARCH_VERSION, workload=workload,
        key=key,
        hw=hw_doc,
        mappings=mappings, orders=orders,
        fused_nonlinear=tuple(part.fused_nonlinear),
        groups=tuple(group_names),
        edges=tuple((e.producer, e.consumer, e.nbytes)
                    for e in part.edges),
        tiles=tiles, lowered=lowered, cost={},
        fixed_wiring=not reconfigurable, tile_mode=tile_mode,
        spatial_mode=spatial_mode, placements=placements)

    # 6. headline numbers under the shared accounting, plus the
    #    tile-aware (ragged-edge) variant used to compare candidate
    #    spaces under identical accounting
    with perf.phase("evaluate"):
        cost_cache: Optional[Dict] = {} if dedup else None
        nc = evaluate_schedule(layers, sched, hw, cycles=cycles_by_name,
                               dedup=dedup, cost_cache=cost_cache)
        nct = evaluate_schedule(layers, sched, hw, tile_aware=True,
                                cycles=cycles_by_name, dedup=dedup,
                                cost_cache=cost_cache)
        # the tile-aware stream traffic lands at the hierarchy's stream
        # level ("sram" on the paper design, "l1" on a 4-level one) —
        # read it by level name, not by the legacy key.  Latency/energy
        # are computed once and combined locally (the properties derive
        # edp/fps from exactly these two numbers).
        from repro_torch.core.costmodel import _stream_level
        stream = _stream_level(hw).name
        lat, en = nc.latency_s, nc.energy_j
        lat_t, en_t = nct.latency_s, nct.energy_j
        sched.cost = {"latency_s": lat, "energy_j": en,
                      "edp": en * lat, "fps": 1.0 / lat,
                      "dram_bytes": float(nc.dram_bytes()),
                      "energy_tiled_j": en_t, "edp_tiled": en_t * lat_t,
                      "sram_tiled_bytes": float(sum(
                          lc.traffic.get(stream, 0)
                          for lc in nct.layers)),
                      # mean spatial utilization over MAC layers — the
                      # number the factored mapspace exists to raise
                      "spatial_util": util_sum / util_n if util_n else 0.0}
    obs.gauge("auto.spatial_util", sched.cost["spatial_util"])
    obs.gauge("auto.edp", sched.cost["edp"])
    return sched
