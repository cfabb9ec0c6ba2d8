"""Dynamic-programming fusion partitioner over the layer chain.

Generalizes the two hand-coded fusion rules of ``core.fusion`` — C2
(nonlinears melt into their producing MAC layer) and C3 (the IBN
pw-expand/pw-project pair runs depth-first) — to arbitrary contiguous
fusion groups: the chain is segmented into groups; inside a group no
tensor ever touches DRAM (nonlinears fuse pixelwise into the writeback
path, MAC-to-MAC intermediates live tiled in the local buffer); at a
group boundary the tensor spills to DRAM iff it exceeds the SRAM
activation budget.

``partition_chain`` minimizes an additive energy scalar (compute + SRAM
/ RF / DRAM traffic + static leakage over cycles) with
``dp[i] = min_j dp[j] + group_cost(j, i)``.  Neither IBN roles nor the
C2/C3 flags are consulted — when fusing an expand/project pair beats
spilling the 4x intermediate, the DP *rediscovers* IBN fusion; when
attaching a LayerNorm to its producer beats bus-streaming it, it
rediscovers pixelwise fusion.  Group feasibility (tile fits the local
buffer, chains are pixel-aligned) comes from ``repro_torch.search.tiler``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.fusion import SpillEdge
from repro_torch.core.workload import (MAC_OPS, NORM, SCAN, SOFTMAX, Layer,
                                 scan_macs, scan_state_bytes)
from repro_torch.search import tiler


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _is_compute(l: Layer) -> bool:
    """MAC layers plus SCAN: the ops that own a fusion group's array
    time.  SCAN is compute for span *structure* (trailing nonlinears
    fuse into its per-chunk writeback) but never joins a multi-compute
    depth-first tile — the state carry serializes the sequence dim, so
    a MAC<->scan interior tensor cannot stream tile-by-tile."""
    return l.op in MAC_OPS or l.op == SCAN


@dataclasses.dataclass(frozen=True)
class Group:
    start: int                       # layers[start:end]
    end: int
    tile: Optional[tiler.GroupTile]  # None for single-MAC / MAC-less
    fused_nonlinear: Tuple[str, ...]
    unfused_nonlinear: Tuple[str, ...]


@dataclasses.dataclass
class Partition:
    groups: List[Group]
    edges: List[SpillEdge]
    cost_pj: float

    @property
    def fused_nonlinear(self) -> Tuple[str, ...]:
        out: List[str] = []
        for g in self.groups:
            out.extend(g.fused_nonlinear)
        return tuple(out)


def _static_pj_per_cycle(hw: HWSpec) -> float:
    return hw.static_mw * 1e-3 / hw.clock_hz * 1e12


def _stream_pj(hw: HWSpec) -> float:
    """pJ/byte of the level operand streaming crosses — the same level
    ``costmodel._mac_layer_cost`` charges, so the DP optimizes the exact
    cost surface the evaluation reports (on the default 3-level design
    this is the SRAM; on a 4-level design it is the L1)."""
    from repro_torch.core.costmodel import _stream_level
    return _stream_level(hw).pj_per_byte


def _mac_base_pj(l: Layer, cyc: int, hw: HWSpec, *,
                 include_sram: bool = True) -> float:
    """Energy of one MAC layer outside fusion decisions (mirrors
    costmodel._mac_layer_cost accounting)."""
    rf = 4 * (l.macs // max(hw.cols, 1) + l.output_elems)
    pj = l.macs * hw.e_mac + rf * hw.e_rf_byte + \
        l.weight_bytes * hw.e_dram_byte + cyc * _static_pj_per_cycle(hw)
    if include_sram:
        pj += (l.input_bytes + l.output_bytes + l.weight_bytes) \
            * _stream_pj(hw)
    return pj


def _scan_cycles(l: Layer, cycles_by_name: Dict[str, int], hw: HWSpec,
                 chunk: int) -> int:
    """A SCAN layer's cycle count: the mapper-derived value when the
    caller provides one, else the default state-dims-on-array mapping —
    the same fallback ``costmodel.cost_network_scheduled`` uses."""
    cyc = cycles_by_name.get(l.name)
    if cyc is None:
        from repro_torch.core import dataflow
        cyc = dataflow.cycles_scan(l, ("k", "c"), hw.rows, hw.cols,
                                   chunk=chunk)
    return cyc


def _scan_pj(l: Layer, cyc: int, hw: HWSpec, chunk: int) -> float:
    """Energy of one SCAN layer at chunk length ``chunk`` (mirrors
    costmodel._scan_layer_cost accounting: full executed MACs, stream
    traffic, and the per-chunk state round trips at the residency
    level).  Both DP paths call exactly this function, so their probe
    sums stay bit-identical."""
    from repro_torch.core.costmodel import scan_state_level
    total = scan_macs(l, chunk)
    rf = 4 * (total // max(hw.cols, 1) + l.output_elems)
    pj = total * hw.e_mac + rf * hw.e_rf_byte + \
        l.weight_bytes * hw.e_dram_byte + cyc * _static_pj_per_cycle(hw)
    pj += (l.input_bytes + l.output_bytes + l.weight_bytes) \
        * _stream_pj(hw)
    n_chunks = _ceil(l.ox, chunk)
    pj += 2 * scan_state_bytes(l) * l.b * n_chunks \
        * scan_state_level(l, hw).pj_per_byte
    return pj


def _unfused_nonlinear_pj(l: Layer, hw: HWSpec) -> float:
    passes = 2 if l.op in (NORM, SOFTMAX) else 1
    stream = 2 * l.input_bytes
    stall = passes * _ceil(stream, hw.dram_bus_bytes_per_cycle)
    return (passes * stream * _stream_pj(hw)
            + l.input_bytes * hw.e_rf_byte
            + stall * _static_pj_per_cycle(hw))


def _group_meta(layers: Sequence[Layer], j: int, i: int,
                tile: Optional[tiler.GroupTile]) -> Group:
    """Materialize the Group record for a chosen span — deferred out of
    the DP probe loop, which only needs the scalar cost."""
    fused: List[str] = []
    unfused: List[str] = []
    seen_mac = False
    for l in layers[j:i]:
        if _is_compute(l):
            seen_mac = True
        elif seen_mac:
            fused.append(l.name)       # pixelwise writeback fusion (C2)
        else:
            unfused.append(l.name)     # no producer in this group
    return Group(start=j, end=i, tile=tile, fused_nonlinear=tuple(fused),
                 unfused_nonlinear=tuple(unfused))


def _group_cost_brute(layers: Sequence[Layer], j: int, i: int,
                      cycles_by_name: Dict[str, int], hw: HWSpec,
                      budgets: Sequence[tiler.LevelBudget],
                      tile_mode: str,
                      scan_chunks: Optional[Dict[str, int]] = None
                      ) -> Optional[Tuple[float, Group]]:
    """Reference per-span cost: the direct derivation every DP probe ran
    before the fast path (kept verbatim as the ``memo=None`` mode) — an
    independent implementation the hoisted/memoized probe loop is
    equality-tested against (``tests/test_search_perf.py``), and the
    dedup-off baseline the ``search.perf.*`` speedup rows measure."""
    sl = layers[j:i]
    comp = [l for l in sl if _is_compute(l)]
    scans = [l for l in sl if l.op == SCAN]
    if scans and len(comp) > 1:
        # the state carry serializes the scan: it never joins a
        # multi-compute depth-first tile
        return None
    macs = [l for l in sl if l.op in MAC_OPS]
    fused: List[str] = []
    unfused: List[str] = []
    pj = 0.0
    seen_mac = False
    for l in sl:
        if _is_compute(l):
            seen_mac = True
        elif seen_mac:
            fused.append(l.name)       # pixelwise writeback fusion (C2)
        else:
            unfused.append(l.name)     # no producer in this group
            pj += _unfused_nonlinear_pj(l, hw)

    tile: Optional[tiler.GroupTile] = None
    if scans:
        l = scans[0]
        if fused and scan_state_bytes(l) > max(
                (cap for _, cap, _ in budgets), default=0):
            # fusing past a chunk boundary needs the state scratch
            # resident at a local level alongside the writeback path —
            # when it fits nowhere on chip the trailing nonlinears
            # cannot ride the per-chunk drain and the span is cut
            return None
        chunk = (scan_chunks or {}).get(l.name, 64)
        pj += _scan_pj(l, _scan_cycles(l, cycles_by_name, hw, chunk),
                       hw, chunk)
    elif len(macs) > 1:
        stream_pj = _stream_pj(hw)
        tile = tiler.tile_group(sl, budgets=budgets, stream_pj=stream_pj,
                                mode=tile_mode)
        if tile is None:
            return None
        interior = tiler.interior_bytes(sl)
        level_pj = next(p for n, _, p in budgets if n == tile.level)
        pj += tile.sram_traffic * stream_pj + 2 * interior * level_pj
        for l in macs:
            pj += _mac_base_pj(l, cycles_by_name[l.name], hw,
                               include_sram=False)
    else:
        for l in macs:
            pj += _mac_base_pj(l, cycles_by_name[l.name], hw)

    return pj, Group(start=j, end=i, tile=tile, fused_nonlinear=tuple(fused),
                     unfused_nonlinear=tuple(unfused))


def _partition_brute(layers: Sequence[Layer],
                     cycles_by_name: Dict[str, int], hw: HWSpec,
                     act_budget: int,
                     budgets: Sequence[tiler.LevelBudget],
                     max_span: int, tile_mode: str,
                     scan_chunks: Optional[Dict[str, int]] = None
                     ) -> Partition:
    """The pre-fastpath DP loop (direct per-span derivation, no memo,
    no hoisting): bit-identical groups/edges/cost to the fast loop."""
    spill_pj = hw.hierarchy.outermost.pj_per_byte
    n = len(layers)
    INF = float("inf")
    dp: List[float] = [INF] * (n + 1)
    dp[0] = 0.0
    choice: List[Optional[Tuple[int, float, Group]]] = [None] * (n + 1)

    for i in range(1, n + 1):
        for j in range(max(0, i - max_span), i):
            if dp[j] == INF:
                continue
            gc = _group_cost_brute(layers, j, i, cycles_by_name, hw,
                                   budgets, tile_mode, scan_chunks)
            if gc is None:
                continue
            pj, grp = gc
            if j > 0:
                nbytes = layers[j - 1].output_bytes
                if nbytes > act_budget:
                    pj += 2 * nbytes * spill_pj
            if dp[j] + pj < dp[i]:
                dp[i] = dp[j] + pj
                choice[i] = (j, pj, grp)

    assert dp[n] < INF, "no feasible partition (single layers are always" \
                        " feasible — this indicates a bug)"
    groups: List[Group] = []
    i = n
    while i > 0:
        j, _, grp = choice[i]        # type: ignore[misc]
        groups.append(grp)
        i = j
    groups.reverse()
    edges: List[SpillEdge] = []
    for gi in range(len(groups) - 1):
        e = _boundary_edge(layers, groups, gi, act_budget)
        if e is not None:
            edges.append(e)
    return Partition(groups=groups, edges=edges, cost_pj=dp[n])


def _boundary_edge(layers: Sequence[Layer], groups: List[Group],
                   gi: int, act_budget: int) -> Optional[SpillEdge]:
    """Spill edge between groups[gi] and groups[gi+1] (None if the
    boundary tensor fits the SRAM activation budget)."""
    g, nxt = groups[gi], groups[gi + 1]
    nbytes = layers[g.end - 1].output_bytes
    if nbytes <= act_budget:
        return None
    prod = g.end - 1
    for idx in range(g.end - 1, g.start - 1, -1):
        if _is_compute(layers[idx]):
            prod = idx
            break
    cons = nxt.start
    for idx in range(nxt.start, nxt.end):
        if _is_compute(layers[idx]):
            cons = idx
            break
    is_ibn = layers[prod].ibn_role in ("expand", "act")
    return SpillEdge(producer=prod, consumer=cons, nbytes=nbytes,
                     is_ibn=is_ibn)


def residence_budgets(hw: HWSpec) -> Tuple[tiler.LevelBudget, ...]:
    """The per-level budget vector for depth-first group intermediates:
    every hierarchy level strictly inside the spill level, with the
    capacity its activation-serving partition grants (the paper's RF
    level is hard-partitioned — interiors live in the 24 kB output RF,
    not the input mem)."""
    return tuple((l.name, l.serve_capacity("output"), l.pj_per_byte)
                 for l in hw.hierarchy.local_levels())


def partition_chain(layers: Sequence[Layer],
                    cycles_by_name: Dict[str, int],
                    hw: Optional[HWSpec] = None, *,
                    act_budget: Optional[int] = None,
                    local_buffer: Optional[int] = None,
                    max_span: int = 10,
                    tile_mode: str = "full",
                    scan_chunks: Optional[Dict[str, int]] = None,
                    memo=None) -> Partition:
    """Optimal contiguous segmentation of the chain into fusion groups.

    ``cycles_by_name`` carries each MAC layer's compute cycles under its
    chosen spatial mapping (the partitioner is mapping-agnostic).
    ``tile_mode`` selects the group-tile candidate space ("full" =
    divisors + imperfect factors, "pow2" = the ablation baseline).
    ``act_budget`` defaults to the hierarchy's spill-level act
    partition; ``local_buffer`` (single-level override, kept for tests /
    ablations) replaces the hierarchy-derived residence budget vector.
    ``memo`` (a ``search.memo.SearchMemo``) selects the fast probe loop:
    span-invariant per-layer terms hoisted out of the O(n * max_span)
    probes, chain-feasibility prechecks, and group-tile searches dedup'd
    by block signature.  Without a memo the original direct per-span
    derivation runs (``_partition_brute``) — the two are bit-identical
    (pinned by the dedup on/off property tests) and the direct form is
    the dedup-off baseline the ``search.perf.*`` rows measure against.
    """
    hw = hw or HWSpec()
    if act_budget is None:
        act_budget = hw.act_budget_bytes
    if local_buffer is None:
        budgets = residence_budgets(hw)
    else:
        budgets = ((hw.hierarchy.innermost.name, local_buffer,
                    hw.e_rf_byte),)
    with obs.span("fusion", layers=len(layers), max_span=max_span,
                  budgets=[n for n, _, _ in budgets]):
        if memo is None:
            return _partition_brute(layers, cycles_by_name, hw,
                                    act_budget, budgets, max_span,
                                    tile_mode, scan_chunks)
        return _partition_fast(layers, cycles_by_name, hw, act_budget,
                               budgets, max_span, tile_mode, memo,
                               scan_chunks)


def _partition_fast(layers: Sequence[Layer],
                    cycles_by_name: Dict[str, int], hw: HWSpec,
                    act_budget: int,
                    budgets: Sequence[tiler.LevelBudget],
                    max_span: int, tile_mode: str, memo,
                    scan_chunks: Optional[Dict[str, int]] = None
                    ) -> Partition:
    """The memoized probe loop (see ``partition_chain``).  When a tracer
    is active it additionally tracks, per DP node, the runner-up
    segmentation total — the backtrace then emits one ``fusion.cut``
    event per chosen group carrying the energy margin that justified
    the boundary and the spilled bytes it pays."""
    spill_pj = hw.hierarchy.outermost.pj_per_byte
    n = len(layers)
    # -- span-invariant terms, hoisted out of the O(n * max_span) DP
    # probe loop (bit-identical: the probes sum the same floats in the
    # same order as the direct per-span derivation did) --
    stream_pj = _stream_pj(hw)
    # "mac" in the structure arrays means compute-class: MAC layers plus
    # SCAN (identical arrays on scan-free chains, so every pre-scan
    # workload's DP runs the bit-exact same probes)
    is_mac = [_is_compute(l) for l in layers]
    is_scan = [l.op == SCAN for l in layers]
    # per-layer energy terms: (with, without) operand streaming for MAC
    # layers, the unfused bus-streaming cost for nonlinears; scans carry
    # their full single-compute-span cost (they never tile into a
    # multi-compute group, so the without-streaming slot is unused)
    mac_pj: List[Tuple[float, float]] = [(0.0, 0.0)] * n
    nl_pj: List[float] = [0.0] * n
    # per-scan trailing-fusion legality: the [K, V] state scratch fits
    # some local residence level
    max_local = max((cap for _, cap, _ in budgets), default=0)
    state_fits = [False] * n
    for idx, l in enumerate(layers):
        if is_scan[idx]:
            chunk = (scan_chunks or {}).get(l.name, 64)
            pj = _scan_pj(l, _scan_cycles(l, cycles_by_name, hw, chunk),
                          hw, chunk)
            mac_pj[idx] = (pj, pj)
            state_fits[idx] = scan_state_bytes(l) <= max_local
        elif is_mac[idx]:
            cyc = cycles_by_name[l.name]
            mac_pj[idx] = (_mac_base_pj(l, cyc, hw),
                           _mac_base_pj(l, cyc, hw, include_sram=False))
        else:
            nl_pj[idx] = _unfused_nonlinear_pj(l, hw)
    # prefix MAC counts + first-MAC-at-or-after, for O(1) span structure
    nmac = [0] * (n + 1)
    for idx in range(n):
        nmac[idx + 1] = nmac[idx] + (1 if is_mac[idx] else 0)
    first_mac = [n] * (n + 1)
    for idx in range(n - 1, -1, -1):
        first_mac[idx] = idx if is_mac[idx] else first_mac[idx + 1]
    last_mac = [-1] * (n + 1)
    for idx in range(n):
        last_mac[idx + 1] = idx if is_mac[idx] else last_mac[idx]
    # depth-first chain feasibility: chain_end[idx] = last layer index of
    # the maximal pairwise-compatible MAC chain starting at MAC idx — a
    # multi-MAC span is fusible iff its last MAC is within its first
    # MAC's chain, which prunes the hopeless tile searches the DP would
    # otherwise probe O(n * max_span) times
    mac_positions = [idx for idx in range(n) if is_mac[idx]]
    chain_end: Dict[int, int] = {}
    for p in range(len(mac_positions) - 1, -1, -1):
        idx = mac_positions[p]
        if p + 1 < len(mac_positions) and tiler.chain_compatible(
                layers[idx], layers[mac_positions[p + 1]]):
            chain_end[idx] = chain_end[mac_positions[p + 1]]
        else:
            chain_end[idx] = idx
    sigs = tuple(l.signature for l in layers)
    # boundary-tensor bytes, probed once per (i, j) pair otherwise
    out_bytes = [l.output_bytes for l in layers]
    # unfused-nonlinear run cost ahead of each position's first MAC:
    # nl_run[j] = nl_pj[j] + nl_pj[j+1] + ... up to (excl.) first_mac[j],
    # accumulated per j in the same left-to-right order the probe loop
    # summed, so the hoisted value is the bit-exact same float
    nl_run = [0.0] * (n + 1)
    for j in range(n):
        s = 0.0
        for idx in range(j, first_mac[j]):
            s += nl_pj[idx]
        nl_run[j] = s
    gtab = memo.raw("group_tile")
    g_hits = g_miss = 0
    _MISS = object()
    tile_group_at = tiler._tile_group_at
    interior_of = tiler.interior_bytes
    replace = dataclasses.replace

    INF = float("inf")
    dp: List[float] = [INF] * (n + 1)
    dp[0] = 0.0
    # chosen (j, tile) per DP node; Group metadata is materialized only
    # for the winning chain after the backtrace
    choice: List[Optional[Tuple[int, Optional[tiler.GroupTile]]]] = \
        [None] * (n + 1)
    # decision provenance (captured once; the per-probe cost is one
    # bool check when untraced, so the --profile speedup is unaffected)
    trace = obs.current() is not None
    best2: List[float] = [INF] * (n + 1)   # runner-up total per node
    n_probed = n_chain_break = n_no_tile = 0
    tile_rej: Dict[str, int] = {}

    for i in range(1, n + 1):
        for j in range(max(0, i - max_span), i):
            if dp[j] == INF:
                continue
            n_probed += 1
            m = nmac[i] - nmac[j]
            fm = first_mac[j]
            tile: Optional[tiler.GroupTile] = None
            # unfused nonlinears: the non-MAC layers before the span's
            # first MAC (everything after one fuses into its writeback)
            if fm < i:
                pj = nl_run[j]
            else:                      # MAC-less span: the run is cut at i
                pj = 0.0
                for idx in range(j, i):
                    pj += nl_pj[idx]
            if m > 1:
                if chain_end[fm] < last_mac[i]:
                    n_chain_break += 1
                    continue           # chain breaks inside the span
                sl = layers[j:i]
                # per-budget tile search through the group_tile memo
                # (same per-capacity result + cross-level energy choice
                # as ``tiler.tile_group``, with the table raw-accessed
                # in the probe loop); the per-level tile never reads
                # access energies, so entries are shared across every
                # DSE variant with the same residence capacity
                tile_pj = 0.0
                gsig = sigs[j:i]
                interior = interior_of(sl)
                for nm, capacity, level_pj in budgets:
                    k = (gsig, capacity, tile_mode)
                    t = gtab.get(k, _MISS)
                    if t is _MISS:
                        t = gtab[k] = tile_group_at(sl, capacity,
                                                    tile_mode)
                        g_miss += 1
                    else:
                        g_hits += 1
                    if t is None:
                        # tile candidate rejected by this budget level
                        tile_rej[nm] = tile_rej.get(nm, 0) + 1
                        continue
                    t_pj = t.sram_traffic * stream_pj \
                        + 2 * interior * level_pj
                    if tile is None or t_pj < tile_pj:
                        tile = t if t.level == nm else \
                            replace(t, level=nm)
                        tile_pj = t_pj
                if tile is None:
                    n_no_tile += 1
                    continue           # no tile fits any budget
                # depth-first group: spill-level traffic comes from the
                # tiler (input re-reads per channel round + weight
                # re-streams per x slab); interior tensors move only
                # through the residence level the tiler chose (write +
                # read per byte at that level's pJ)
                pj += tile_pj
                for idx in range(fm, i):
                    if is_mac[idx]:
                        pj += mac_pj[idx][1]
            elif m == 1:
                if is_scan[fm] and i - 1 > fm and not state_fits[fm]:
                    # trailing nonlinears cannot fuse across the chunk
                    # boundary when the state scratch fits no local
                    # level — the span is cut right after the scan
                    n_chain_break += 1
                    continue
                pj += mac_pj[fm][0]
            # boundary spill charged when this group is *opened*, i.e.
            # the tensor entering it came from the previous boundary
            if j > 0:
                nbytes = out_bytes[j - 1]
                if nbytes > act_budget:
                    pj += 2 * nbytes * spill_pj
            total = dp[j] + pj
            if total < dp[i]:
                if trace:
                    best2[i] = dp[i]   # incumbent demoted to runner-up
                dp[i] = total
                choice[i] = (j, tile)
            elif trace and total < best2[i]:
                best2[i] = total
    if g_hits:
        memo.perf.count("memo.group_tile.hit", g_hits)
    if g_miss:
        memo.perf.count("memo.group_tile.miss", g_miss)
    obs.count("fusion.spans_probed", n_probed)
    if n_chain_break:
        obs.count("fusion.spans_chain_infeasible", n_chain_break)
    if n_no_tile:
        obs.count("fusion.spans_no_tile", n_no_tile)
    for nm, c in tile_rej.items():
        obs.count(f"tiler.reject.{nm}", c)

    assert dp[n] < INF, "no feasible partition (single layers are always" \
                        " feasible — this indicates a bug)"
    groups: List[Group] = []
    i = n
    while i > 0:
        j, tile = choice[i]          # type: ignore[misc]
        groups.append(_group_meta(layers, j, i, tile))
        i = j
    groups.reverse()

    edges: List[SpillEdge] = []
    for gi in range(len(groups) - 1):
        e = _boundary_edge(layers, groups, gi, act_budget)
        if e is not None:
            edges.append(e)
    if trace:
        obs.count("fusion.groups", len(groups))
        for g in groups:
            spill = 0
            if g.start > 0 and out_bytes[g.start - 1] > act_budget:
                spill = out_bytes[g.start - 1]
            margin = best2[g.end] - dp[g.end] \
                if best2[g.end] < INF else None
            obs.event("fusion.cut", start=g.start, end=g.end,
                      layers=g.end - g.start,
                      head=layers[g.start].name,
                      level=g.tile.level if g.tile else None,
                      margin_pj=margin, boundary_spill_bytes=spill)
    return Partition(groups=groups, edges=edges, cost_pj=dp[n])
