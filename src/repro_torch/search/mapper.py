"""Spatial-mapping + temporal-loop-order enumeration (ZigZag-style).

The paper hand-picks three spatial mappings (OX|C, C|K, C|FX) and one
pixelwise temporal re-ordering; this module opens the full space:

  spatial  : any ordered pair of loop dims (row_dim, col_dim) unrolled
             over a parametric rows x cols PE array — the legacy trio is
             three points of the ~42-point space — plus *factored*
             assignments (``spatial_mode="factored"``, the default):
             each axis takes an ordered (dim, factor) tuple whose
             product fits the axis (e.g. 4xOX * 4xK on 16 rows), so a
             layer whose best dim is smaller than the array replicates
             the residual slots onto a second dim instead of stranding
             PEs.  Costed with ``core.dataflow.cycles_generic`` /
             ``cycles_factored``; ``spatial_mode="pair"`` is the
             pair-only ablation (bit-identical to the pre-factored
             search).
  temporal : permutations of the three macro loops (X = pixels,
             K = output channels, C = reduction), tiled against the
             PE-coupled buffer budgets of the ``MemoryHierarchy``
             carried by ``costmodel.HWSpec``.  Loop order decides which
             tensor stays resident and which re-streams — and whether
             the pixelwise (C2) nonlinear fusion is legal at writeback.

Each temporal choice additionally *places* every operand's stationary
tile at a memory level (the innermost level that serves it and holds
the tile) and charges the per-round fill/drain traffic to the level
that transfer actually crosses, so candidates are ranked by per-level
energy — on a deeper hierarchy, a loop order that keeps its reuse in a
cheap L1 beats one that re-streams from an expensive L2, which the old
single-SRAM aggregate could not see.

``best_mapping``/``best_temporal`` are what the auto-scheduler
(`repro_torch.search.auto`) calls per layer; nothing here is EdgeNeXt-specific.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core import dataflow
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.tiling import Tiling, tile_candidates
from repro_torch.core.workload import MAC_OPS, Layer

GenericMapping = Tuple[str, str]


# ---------------------------------------------------------------------------
# Spatial mappings
# ---------------------------------------------------------------------------


SPATIAL_MODES = ("factored", "pair")


@dataclasses.dataclass(frozen=True)
class MappingChoice:
    # a (row_dim, col_dim) pair, or a factored per-axis
    # ((dim, factor), ...) assignment when that strictly wins
    mapping: Tuple
    cycles: int
    utilization: float


def enumerate_mappings(layer: Layer) -> Iterator[GenericMapping]:
    """All ordered dim pairs worth unrolling for this layer.  Degenerate
    dims (extent 1 — including dims the op does not carry, e.g. K on
    depthwise) are skipped up front: unrolling them is a no-op the
    temporal loops already cover, so they never consume enumeration
    slots.  A layer with fewer than two non-degenerate dims still
    yields a non-empty set — the lone useful dim (or the leading
    spatial dims outright) padded with one no-op partner, so every MAC
    layer of every workload has a valid, non-raising mapping."""
    sizes = dataflow.dim_sizes(layer)
    useful = [d for d in dataflow.SPATIAL_DIMS if sizes[d] > 1]
    if len(useful) >= 2:
        yield from itertools.permutations(useful, 2)
        return
    if not useful:                      # fully degenerate (1x1 MAC)
        yield from itertools.permutations(dataflow.SPATIAL_DIMS[:2])
        return
    partner = next(d for d in dataflow.SPATIAL_DIMS if d != useful[0])
    yield from itertools.permutations((useful[0], partner))


def _factor_menu(size: int, axis_len: int) -> List[int]:
    """Per-dim unroll factors worth trying inside a factored axis:
    powers of two below the axis (a full-axis factor is the single-dim
    case) plus the exact-extent replication pivot for a dim smaller
    than the axis.  Factors beyond the extent are dominated (same
    ceil, more slots burned) and skipped."""
    out = []
    f = 2
    while f < axis_len and f < size:
        out.append(f)
        f *= 2
    if 2 <= size < axis_len and size not in out:
        out.append(size)
    return out


def _axis_options(sizes: Dict[str, int], red: frozenset, useful: List[str],
                  axis_len: int) -> List[Tuple[Tuple[str, int], ...]]:
    """Factored candidates for one axis: every single-dim full-axis
    unrolling plus every legal two-dim split — ordered (d1, d2) with d1
    non-reduction (the accumulation wiring needs contiguous segments,
    so a reduction dim can only sit innermost; see
    ``dataflow.factored_legal``)."""
    opts: List[Tuple[Tuple[str, int], ...]] = \
        [((d, axis_len),) for d in useful]
    for d1 in useful:
        if d1 in red:
            continue
        menu1 = _factor_menu(sizes[d1], axis_len)
        for d2 in useful:
            if d2 == d1:
                continue
            menu2 = _factor_menu(sizes[d2], axis_len)
            for f1 in menu1:
                for f2 in menu2:
                    if f1 * f2 <= axis_len:
                        opts.append(((d1, f1), (d2, f2)))
    return opts


def _best_factored(layer: Layer, rows: int, cols: int,
                   incumbent: MappingChoice) -> MappingChoice:
    """Scan the factored mapspace for a candidate strictly beating the
    pair ``incumbent`` (ties keep the pair — a degenerate factored
    search must reproduce the pair schedule bit for bit).

    Dominance pruning, exact at every step:
      * ``ceil(prod(dims) / (rows * cols))`` is the global cycle floor
        of ANY spatial mapping; an incumbent already there skips the
        whole scan (most large pwconv/matmul layers), and reaching it
        mid-scan stops early;
      * after fixing the row axis, applying any column assignment
        divides the remaining count by at most ``cols`` (factor
        products fit the axis, counts are integers), so
        ``ceil(partial / cols)`` lower-bounds every column option;
      * the inner loop composes ceil-divisions incrementally via
        ``ceil(ceil(s/a)/b) == ceil(s/(a*b))`` — no per-candidate dict
        building.
    """
    sizes = dataflow.dim_sizes(layer)
    red = frozenset(dataflow.reduction_dims(layer))
    useful = [d for d in dataflow.SPATIAL_DIMS if sizes[d] > 1]
    if len(useful) < 2:
        return incumbent                # nothing to factor
    dims = list(dataflow.SPATIAL_DIMS)
    s_all = [sizes[d] for d in dims]
    total = 1
    for s in s_all:
        total *= s
    floor_cyc = -(-total // (rows * cols))
    best_cyc = incumbent.cycles
    if best_cyc <= floor_cyc:
        # the pair space is already optimal: the whole factored scan is
        # dominance-pruned (provenance counter, no-op untraced)
        obs.count("mapper.spatial.floor_skipped")
        return incumbent
    idx = {d: i for i, d in enumerate(dims)}
    # column options pre-resolved to (axis, [(dim index, factor)],
    # reduction dims) so the hot loop runs on ints
    cols_pre = [(ca, [(idx[d], f) for d, f in ca],
                 [d for d, _ in ca if d in red])
                for ca in _axis_options(sizes, red, useful, cols)]
    # row options sorted by their post-unroll partial product (stable, so
    # equal partials keep enumeration order): the per-row lower bound
    # ceil(partial / cols) is then monotone and the scan BREAKS at the
    # first row that cannot beat the incumbent instead of filtering
    rows_pre = []
    for ra in _axis_options(sizes, red, useful, rows):
        rem = list(s_all)
        for d, f in ra:
            i = idx[d]
            rem[i] = -(-rem[i] // f)
        partial = 1
        for r in rem:
            partial *= r
        rows_pre.append((partial, ra, rem,
                         [d for d, _ in ra if d in red]))
    rows_pre.sort(key=lambda t: t[0])
    best_fm: Optional[Tuple] = None
    n_rows = n_eval = 0
    for partial, ra, rem, r_red in rows_pre:
        if -(-partial // cols) > best_cyc:
            break
        n_rows += 1
        for ca, cf, c_red in cols_pre:
            # a reduction dim never splits across both axes
            if r_red and c_red and any(d in r_red for d in c_red):
                continue
            n_eval += 1
            cyc = partial
            for i, f in cf:
                r = rem[i]
                cyc = cyc // r * (-(-r // f))
            if cyc < best_cyc or (cyc == best_cyc and best_fm is not None
                                  and (ra, ca) < best_fm):
                best_cyc = cyc
                best_fm = (ra, ca)
        if best_cyc <= floor_cyc:
            break                       # nothing can rank lower
    # decision provenance: factored candidates costed vs whole row
    # assignments dominance-pruned by the ceil(partial / cols) bound
    obs.count("mapper.spatial.factored_evaluated", n_eval)
    pruned_rows = len(rows_pre) - n_rows
    if pruned_rows:
        obs.count("mapper.spatial.factored_rows_pruned", pruned_rows)
    if best_fm is None:
        return incumbent
    return MappingChoice(best_fm, best_cyc,
                         layer.macs / (best_cyc * rows * cols))


def best_mapping(layer: Layer, rows: int = 16, cols: int = 16, *,
                 fixed_wiring: bool = False,
                 spatial_mode: str = "factored",
                 memo=None) -> MappingChoice:
    """Min-cycle spatial mapping for one layer (deterministic ties).

    ``spatial_mode="factored"`` (default) extends the ordered-pair
    space with factored row/col assignments; a factored mapping is
    returned only when it strictly beats every pair (equal-cycle ties
    keep the pair, so a degenerate factored search IS the pair search).
    ``spatial_mode="pair"`` is the pair-only ablation.  The
    non-reconfigurable fixed-wiring array cannot segment its hard-wired
    column adder tree, so it always searches pairs only.

    ``memo`` (a ``search.memo.SearchMemo``) keys the result by the
    layer's content signature — independent of the memory hierarchy, so
    one entry serves every repeat of the shape in the network *and*
    every memory-sizing variant of a DSE sweep."""
    assert layer.op in MAC_OPS, layer.op
    if spatial_mode not in SPATIAL_MODES:
        raise ValueError(f"unknown spatial_mode {spatial_mode!r}; "
                         f"choose from {SPATIAL_MODES}")
    if memo is not None:
        return memo.lookup(
            "spatial",
            (layer.signature, rows, cols, fixed_wiring, spatial_mode),
            lambda: best_mapping(layer, rows, cols,
                                 fixed_wiring=fixed_wiring,
                                 spatial_mode=spatial_mode))
    best: Optional[MappingChoice] = None
    n_pairs = 0
    for m in enumerate_mappings(layer):
        n_pairs += 1
        cyc = dataflow.cycles_generic(layer, m, rows, cols,
                                      fixed_wiring=fixed_wiring)
        if best is None or (cyc, m) < (best.cycles, best.mapping):
            best = MappingChoice(m, cyc,
                                 layer.macs / (cyc * rows * cols))
    assert best is not None
    if spatial_mode == "factored" and not fixed_wiring:
        best = _best_factored(layer, rows, cols, best)
    obs.count("mapper.spatial.pairs_enumerated", n_pairs)
    if obs.current() is not None:
        # one provenance event per *computed* layer mapping (memo hits
        # replay the decision without re-emitting it)
        obs.event("mapper.spatial", layer=layer.name,
                  mapping=dataflow.mapping_label(best.mapping),
                  cycles=best.cycles, pairs_enumerated=n_pairs,
                  utilization=round(best.utilization, 4))
    return best


SCAN_SPATIAL_DIMS = ("b", "k", "c")


def enumerate_scan_mappings(layer: Layer) -> Iterator[GenericMapping]:
    """Ordered dim pairs for a SCAN layer.  Only b / k / c are ever
    offered: the sequence dim carries the [K, V] state chunk to chunk,
    so spatially splitting (or reordering) it would race the carry —
    the invariant the scan property tests pin."""
    sizes = dataflow.dim_sizes(layer)
    useful = [d for d in SCAN_SPATIAL_DIMS if sizes[d] > 1]
    if len(useful) >= 2:
        yield from itertools.permutations(useful, 2)
        return
    if not useful:
        yield from itertools.permutations(SCAN_SPATIAL_DIMS[:2])
        return
    partner = next(d for d in SCAN_SPATIAL_DIMS if d != useful[0])
    yield from itertools.permutations((useful[0], partner))


def best_scan_mapping(layer: Layer, rows: int = 16, cols: int = 16, *,
                      chunk: int, fixed_wiring: bool = False,
                      spatial_mode: str = "factored",
                      memo=None) -> MappingChoice:
    """Min-cycle spatial mapping for a SCAN layer at chunk length
    ``chunk`` (``dataflow.cycles_scan`` costing, deterministic ties,
    same factored-beats-pair-only-strictly rule as ``best_mapping``).
    The chunk is part of the memo key: the per-chunk GEMM shapes — and
    with them the best unrolling — change with the chunk length."""
    from repro_torch.core.workload import SCAN, scan_macs
    assert layer.op == SCAN, layer.op
    if spatial_mode not in SPATIAL_MODES:
        raise ValueError(f"unknown spatial_mode {spatial_mode!r}; "
                         f"choose from {SPATIAL_MODES}")
    if memo is not None:
        return memo.lookup(
            "spatial",
            (layer.signature, rows, cols, fixed_wiring, spatial_mode,
             "scan", chunk),
            lambda: best_scan_mapping(layer, rows, cols, chunk=chunk,
                                      fixed_wiring=fixed_wiring,
                                      spatial_mode=spatial_mode))
    smacs = scan_macs(layer, chunk)
    best: Optional[MappingChoice] = None
    n_pairs = 0
    for m in enumerate_scan_mappings(layer):
        n_pairs += 1
        cyc = dataflow.cycles_scan(layer, m, rows, cols, chunk=chunk,
                                   fixed_wiring=fixed_wiring)
        if best is None or (cyc, m) < (best.cycles, best.mapping):
            best = MappingChoice(m, cyc, smacs / (cyc * rows * cols))
    assert best is not None
    if spatial_mode == "factored" and not fixed_wiring:
        sizes = dataflow.dim_sizes(layer)
        red = frozenset(dataflow.reduction_dims(layer))
        useful = [d for d in SCAN_SPATIAL_DIMS if sizes[d] > 1]
        if len(useful) >= 2:
            best_cyc, best_fm = best.cycles, None
            for ra in _axis_options(sizes, red, useful, rows):
                for ca in _axis_options(sizes, red, useful, cols):
                    fm = (ra, ca)
                    if not dataflow.factored_legal(layer, fm, rows, cols):
                        continue
                    cyc = dataflow.cycles_scan(layer, fm, rows, cols,
                                               chunk=chunk)
                    if cyc < best_cyc or (cyc == best_cyc
                                          and best_fm is not None
                                          and fm < best_fm):
                        best_cyc, best_fm = cyc, fm
            if best_fm is not None:
                best = MappingChoice(best_fm, best_cyc,
                                     smacs / (best_cyc * rows * cols))
    obs.count("mapper.spatial.scan_enumerated", n_pairs)
    if obs.current() is not None:
        obs.event("mapper.spatial", layer=layer.name,
                  mapping=dataflow.mapping_label(best.mapping),
                  cycles=best.cycles, chunk=chunk,
                  utilization=round(best.utilization, 4))
    return best


def best_fixed_mapping(layers: List[Layer], rows: int = 16,
                       cols: int = 16) -> GenericMapping:
    """Single network-wide mapping for the non-reconfigurable array: the
    mapping minimizing *total* cycles when every layer must use it."""
    cands: set = set()
    for l in layers:
        if l.op in MAC_OPS:
            cands.update(enumerate_mappings(l))
    best_m, best_cyc = None, None
    for m in sorted(cands):
        tot = sum(dataflow.cycles_generic(l, m, rows, cols,
                                          fixed_wiring=True)
                  for l in layers if l.op in MAC_OPS)
        if best_cyc is None or tot < best_cyc:
            best_m, best_cyc = m, tot
    assert best_m is not None
    return best_m


# ---------------------------------------------------------------------------
# Temporal loop orders
# ---------------------------------------------------------------------------

MACRO_LOOPS = ("x", "k", "c")      # pixels | output channels | reduction


@dataclasses.dataclass(frozen=True)
class TemporalChoice:
    order: Tuple[str, str, str]    # outermost -> innermost
    tile_x: int
    tile_k: int
    tile_c: int
    sram_bytes: int                # aggregate streamed bytes (all levels)
    pixelwise: bool                # channel-stat fusion legal at writeback
    # operand -> memory-level name where its stationary tile resides
    placement: Tuple[Tuple[str, str], ...] = ()
    # level name -> fill/drain bytes crossing that level's port
    level_bytes: Tuple[Tuple[str, int], ...] = ()
    energy_pj: float = 0.0         # per-level traffic x pJ/byte (rank key)


def macro_extents(layer: Layer) -> Tuple[int, int, int]:
    """(n_x, n_k, n_c): pixels, output channels, reduction extent."""
    n_x = layer.b * layer.ox * layer.oy
    if layer.op == "dwconv":
        return n_x, layer.c, layer.fx * layer.fy
    return n_x, layer.k, layer.c * layer.fx * layer.fy


def _traffic(layer: Layer, order: Tuple[str, ...],
             trips: dict) -> Dict[str, int]:
    """Per-operand bytes moved under ``order``.  A tensor re-streams
    once per iteration of a loop that does not index it and sits outside
    one of its loops; the innermost loop reuses whatever is resident.

    Same ragged-edge accounting as ``core.tiling``: each re-stream moves
    the tensor's exact byte volume (a ragged tile is smaller) while the
    trip counts are ceil-rounds, so the ragged round pays the full
    per-round re-stream of the *other* tensors."""
    inner = order[-1]
    return {
        "weight": layer.weight_bytes * (1 if inner == "x" else trips["x"]),
        "input": layer.input_bytes * (1 if inner == "k" else trips["k"]),
        # partial outputs spill + reload per extra reduction round
        "output": layer.output_bytes * (1 if inner == "c"
                                        else 2 * trips["c"] - 1),
    }


def _tile_bytes(layer: Layer, tx: int, tk: int, tc: int
                ) -> Dict[str, int]:
    """Resident-tile footprint per operand: the (tile_x, tile_c) operand
    block, the (tile_k, tile_c) weight block, and the (tile_x, tile_k)
    32-bit psum block."""
    bytes_per = max(1, layer.bits // 8)
    return {"input": tx * tc * bytes_per,
            "weight": tk * tc * bytes_per,
            "output": 4 * tx * tk}


def place_loops(layer: Layer, hw: HWSpec, tx: int, tk: int, tc: int,
                per_operand: Dict[str, int]
                ) -> Tuple[Dict[str, str], Dict[str, int], float]:
    """Place each operand's stationarity at a memory level and charge
    its fill/drain traffic to the level that transfer crosses.

    Placement: the innermost level that serves the operand and holds its
    resident tile (``MemoryHierarchy.stationary_level``).  Traffic: a
    tile resident in the PE-coupled buffers refills from the next
    serving level up; an operand too large for them streams past the
    array straight from its stationary level
    (``MemoryHierarchy.fill_level``).  Returns (placement, per-level
    bytes, energy) — energy is the mapper's rank key.
    """
    tiles = _tile_bytes(layer, tx, tk, tc)
    h = hw.hierarchy
    placement: Dict[str, str] = {}
    level_bytes: Dict[str, int] = {}
    energy = 0.0
    for operand, nbytes in per_operand.items():
        placement[operand] = h.stationary_level(
            operand, tiles[operand]).name
        fill = h.fill_level(operand, tiles[operand])
        if nbytes:
            level_bytes[fill.name] = level_bytes.get(fill.name, 0) + nbytes
            energy += nbytes * fill.pj_per_byte
    return placement, level_bytes, energy


def _pixelwise_ok(order: Tuple[str, ...], trips: dict) -> bool:
    """C2 legality: all output channels of a pixel block must be final
    in the writeback buffer before the block is evicted — the reduction
    must complete innermost and the K loop must not be split across
    outer X iterations."""
    if order[-1] != "c" and trips["c"] > 1:
        return False
    xi, ki = order.index("x"), order.index("k")
    return ki > xi or trips["k"] == 1 or trips["x"] == 1


def enumerate_temporal(layer: Layer, hw: HWSpec,
                       tile_mode: str = "full") -> Iterator[TemporalChoice]:
    """Loop orders x budget-driven tile sizes for one MAC layer.

    Tiles are bounded by the innermost (PE-coupled) hierarchy level: its
    output partition holds the (tile_x, tile_k) 32-bit psum block; its
    input partition holds the (tile_x, tile_c) operand block.  tile_x
    candidates come from the shared divisor + imperfect-factor
    enumeration (``core.tiling``); the pivots are the largest x-tiles
    keeping the full K extent in the RF and the full reduction extent in
    the input memory.  Trip counts are ragged-aware ceil-rounds over the
    same ``Tiling`` model the group tiler charges.  Every candidate
    carries its loop placement (operand stationarity level) and the
    per-level fill/drain traffic it implies.
    """
    n_x, n_k, n_c = macro_extents(layer)
    bytes_per = max(1, layer.bits // 8)
    inner = hw.hierarchy.innermost
    out_buf = inner.serve_capacity("output")
    in_buf = inner.serve_capacity("input")
    pivots = (out_buf // (4 * n_k), in_buf // (bytes_per * n_c))
    for tx in tile_candidates(n_x, extra=pivots, mode=tile_mode):
        tk = min(n_k, out_buf // (4 * tx))
        tc = min(n_c, in_buf // (bytes_per * tx))
        if tk < 1 or tc < 1:
            continue
        trips = {"x": Tiling(n_x, tx).rounds, "k": Tiling(n_k, tk).rounds,
                 "c": Tiling(n_c, tc).rounds}
        for order in itertools.permutations(MACRO_LOOPS):
            per_operand = _traffic(layer, order, trips)
            placement, level_bytes, energy = place_loops(
                layer, hw, tx, tk, tc, per_operand)
            yield TemporalChoice(
                order=order, tile_x=tx, tile_k=tk, tile_c=tc,
                sram_bytes=sum(per_operand.values()),
                pixelwise=_pixelwise_ok(order, trips),
                placement=tuple(sorted(placement.items())),
                level_bytes=tuple(sorted(level_bytes.items())),
                energy_pj=energy)


# All six macro-loop permutations in the enumeration (= tie-break)
# order of ``itertools.permutations(MACRO_LOOPS)``.
_ORDERS: Tuple[Tuple[str, str, str], ...] = \
    tuple(itertools.permutations(MACRO_LOOPS))
# Streamed bytes (hence energy) depend on the *innermost* loop only, so
# the selection scan reduces each tile to three candidates: per inner
# loop, its orders pre-sorted ascending — the first legal one is the
# tie-break winner among that inner's equal-energy permutations.
_ORDERS_BY_INNER: Dict[str, Tuple[Tuple[str, str, str], ...]] = {
    inner: tuple(sorted(o for o in _ORDERS if o[-1] == inner))
    for inner in MACRO_LOOPS}


def _temporal_tiles(layer: Layer, in_buf: int, out_buf: int,
                    tile_mode: str) -> Tuple[Tuple[int, ...], ...]:
    """The pJ- and placement-independent slice of the temporal mapspace:
    per feasible tile point ``(tx, tk, tc, trips_x, trips_k, trips_c,
    tile_input_bytes, tile_weight_bytes, tile_output_bytes,
    w_resident, w_streaming, i_resident, i_streaming, o_resident,
    o_streaming)`` — the last six are the per-operand streamed-byte
    totals under the two regimes the inner-loop choice switches between
    (``_traffic``'s multipliers, precomputed so selection is three
    multiply-adds per inner loop).

    Depends only on the layer's macro extents and the innermost
    (PE-coupled) buffer capacities — NOT on outer-level capacities or
    any access energy — so one table serves every repeat of the layer
    shape and every DSE variant that keeps the PE-coupled buffers
    (resizing or repricing outer levels only re-resolves placements and
    re-costs, it never re-enumerates).  Mirrors ``enumerate_temporal``'s
    tile loop exactly; the orders fan out at selection time."""
    n_x, n_k, n_c = macro_extents(layer)
    bytes_per = max(1, layer.bits // 8)
    w_b, i_b, o_b = layer.weight_bytes, layer.input_bytes, \
        layer.output_bytes
    pivots = (out_buf // (4 * n_k), in_buf // (bytes_per * n_c))
    out = []
    for tx in tile_candidates(n_x, extra=pivots, mode=tile_mode):
        tk = min(n_k, out_buf // (4 * tx))
        tc = min(n_c, in_buf // (bytes_per * tx))
        if tk < 1 or tc < 1:
            continue
        # trip counts == Tiling(n, t).rounds: candidates never exceed
        # the extent, so the ceil-div is the whole ragged model here
        rx, rk, rc = -(-n_x // tx), -(-n_k // tk), -(-n_c // tc)
        out.append((tx, tk, tc, rx, rk, rc,
                    tx * tc * bytes_per, tk * tc * bytes_per, 4 * tx * tk,
                    w_b, w_b * rx, i_b, i_b * rk, o_b,
                    o_b * (2 * rc - 1)))
    return tuple(out)


def _placement_resolver(hw: HWSpec, memo):
    """Build the (stationary level, fill level)-name resolver for one
    ``_best_temporal_fast`` call: raw access to the memo's placement
    table keyed on the hierarchy's capacity signature (placement never
    reads access energies, so repriced DSE variants share entries),
    with hits/misses bulk-reported by the returned ``flush``."""
    h = hw.hierarchy
    if memo is None:
        return (lambda operand, t_bytes:
                (h.stationary_level(operand, t_bytes).name,
                 h.fill_level(operand, t_bytes).name)), lambda: None
    cap = h.cap_signature
    tab = memo.raw("placement")
    # two-level table — (cap signature, operand) prefetches an
    # int-keyed dict, so the per-tile hot lookup hashes one small int
    subs: Dict[str, Dict[int, Tuple[str, str]]] = {}
    for operand in ("weight", "input", "output"):
        sub = tab.get((cap, operand))
        if sub is None:
            sub = tab[(cap, operand)] = {}
        subs[operand] = sub
    stats = [0, 0]                                  # hits, misses

    def resolve(operand: str, t_bytes: int) -> Tuple[str, str]:
        sub = subs[operand]
        v = sub.get(t_bytes)
        if v is None:
            v = sub[t_bytes] = (h.stationary_level(operand, t_bytes).name,
                                h.fill_level(operand, t_bytes).name)
            stats[1] += 1
        else:
            stats[0] += 1
        return v

    def flush() -> None:
        if stats[0]:
            memo.perf.count("memo.placement.hit", stats[0])
        if stats[1]:
            memo.perf.count("memo.placement.miss", stats[1])

    return resolve, flush


def best_temporal(layer: Layer, hw: HWSpec, *,
                  require_pixelwise: bool = False,
                  tile_mode: str = "full",
                  memo=None, brute: bool = False
                  ) -> Optional[TemporalChoice]:
    """Min-energy temporal schedule — per-level traffic weighted by each
    level's pJ/byte, so deeper hierarchies rank candidates by where the
    re-streams actually land (on the default 3-level design every stream
    crosses the single SRAM, making this ordering identical to the old
    min-aggregate-traffic rule).  Optionally restricted to orders where
    the C2 pixelwise fusion of trailing channel-stat nonlinears is
    legal.  Returns None only if no tile fits the buffers at all.

    Two bit-identical implementations (``tests/test_search_perf.py``
    pins the equivalence):

      ``brute=True``  — full enumeration through ``enumerate_temporal``
                        (the reference semantics, and the dedup-off
                        baseline the BENCH speedup rows measure against);
      default (fast)  — the pJ-independent tile table is built once
                        (hoisting placement resolution and fill/drain
                        structure out of the 6-permutation inner loop,
                        and memoized per layer signature when ``memo``
                        is given), tiles whose energy lower bound cannot
                        beat the incumbent are dominance-pruned, and
                        only the winning candidate materializes a full
                        ``TemporalChoice``.
    """
    if brute:
        best: Optional[TemporalChoice] = None
        for t in enumerate_temporal(layer, hw, tile_mode=tile_mode):
            if require_pixelwise and not t.pixelwise:
                continue
            if best is None or (t.energy_pj, t.order, t.tile_x) < \
                    (best.energy_pj, best.order, best.tile_x):
                best = t
        return best
    if memo is not None:
        tab = memo.raw("temporal")
        key = (layer.signature, hw.hierarchy.signature, require_pixelwise,
               tile_mode)
        try:
            t = tab[key]
        except KeyError:
            memo.perf.count("memo.temporal.miss")
            t = tab[key] = _best_temporal_fast(
                layer, hw, require_pixelwise, tile_mode, memo)
            return t
        memo.perf.count("memo.temporal.hit")
        return t
    return _best_temporal_fast(layer, hw, require_pixelwise, tile_mode,
                               None)


def _resolved_rows(layer: Layer, hw: HWSpec, tile_mode: str, memo
                   ) -> Tuple[Tuple, ...]:
    """The temporal mapspace with placements resolved: per feasible tile
    ``(tx, tk, tc, trips..., (stationary names), (fill names))`` —
    everything the selection scan reads except the pJ/byte it ranks by.
    Two memo tiers: the raw tile table keys on the innermost buffer
    capacities only (shared across DSE variants resizing outer levels),
    the resolved rows key on the full capacity signature (shared across
    variants that only reprice)."""
    h = hw.hierarchy
    inner_lvl = h.innermost
    in_buf = inner_lvl.serve_capacity("input")
    out_buf = inner_lvl.serve_capacity("output")

    def build() -> Tuple[Tuple, ...]:
        if memo is not None:
            tiles = memo.lookup(
                "table", (layer.signature, in_buf, out_buf, tile_mode),
                lambda: _temporal_tiles(layer, in_buf, out_buf,
                                        tile_mode))
        else:
            tiles = _temporal_tiles(layer, in_buf, out_buf, tile_mode)
        resolve, flush = _placement_resolver(hw, memo)
        # input and psum tiles fit the innermost buffers by construction
        # (tk/tc are derived from its serve capacities), so their
        # stationarity is always the innermost level and their fill the
        # first outer level serving them — per-hierarchy constants,
        # exactly what ``stationary_level``/``fill_level`` return for
        # any feasible tile.  Only the weight tile's residence depends
        # on its size.
        st_io = inner_lvl.name
        fill_i = h.fill_for_placement("input", st_io).name
        fill_o = h.fill_for_placement("output", st_io).name
        rows = []
        for row in tiles:
            sw = resolve("weight", row[7])
            rows.append(row + ((sw[0], st_io, st_io),
                               (sw[1], fill_i, fill_o)))
        flush()
        return tuple(rows)

    if memo is None:
        return build()
    return memo.lookup(
        "resolved", (layer.signature, h.cap_signature, tile_mode), build)


def _best_temporal_fast(layer: Layer, hw: HWSpec,
                        require_pixelwise: bool, tile_mode: str,
                        memo) -> Optional[TemporalChoice]:
    rows = _resolved_rows(layer, hw, tile_mode, memo)
    pj = {l.name: l.pj_per_byte for l in hw.hierarchy.levels}

    best_key = None        # (energy, order, tile_x) — the brute rank key
    best_pick = None       # the winning resolved row
    n_pruned = n_eval = 0
    for row in rows:
        (tx, _tk, _tc, rx, rk, rc, _ti, _tw, _to,
         w0, w1, i0, i1, o0, o1, _st, fills) = row
        pj_w = pj[fills[0]]
        pj_i = pj[fills[1]]
        pj_o = pj[fills[2]]
        # dominance prune: with every re-stream multiplier at its floor
        # of 1 the energy is a true lower bound (same accumulation order
        # as ``place_loops``, and float addition is monotone), so a tile
        # that cannot reach the incumbent's energy is skipped without
        # touching the order loop.  Strict >: an equal-energy tile may
        # still win the (order, tile_x) tie-break.
        if best_key is not None:
            lb = 0.0
            if w0:
                lb += w0 * pj_w
            if i0:
                lb += i0 * pj_i
            if o0:
                lb += o0 * pj_o
            if lb > best_key[0]:
                n_pruned += 1
                continue
        n_eval += 1
        # per-operand streamed bytes depend on the inner loop only
        # (``_traffic``, precomputed in the table rows); energies
        # accumulate in the same weight, input, output order as
        # ``place_loops`` so floats match the brute path bit-for-bit.
        # Per inner loop only the lexicographically first legal order
        # can win (equal energy), so each tile yields <= 3 candidates.
        cand = None
        for inner, wb, ib, ob in (("x", w0, i1, o1), ("k", w1, i0, o1),
                                  ("c", w1, i1, o0)):
            order = None
            if not require_pixelwise:
                order = _ORDERS_BY_INNER[inner][0]
            else:
                for o in _ORDERS_BY_INNER[inner]:
                    # inline _pixelwise_ok on the raw trip counts
                    if o[-1] != "c" and rc > 1:
                        break
                    if o.index("k") > o.index("x") or rk == 1 or rx == 1:
                        order = o
                        break
            if order is None:
                continue
            e = 0.0
            if wb:
                e += wb * pj_w
            if ib:
                e += ib * pj_i
            if ob:
                e += ob * pj_o
            if cand is None or (e, order) < cand:
                cand = (e, order)
        if cand is None:
            continue
        key3 = (cand[0], cand[1], tx)
        if best_key is None or key3 < best_key:
            best_key = key3
            best_pick = row

    # decision provenance: tiles costed through the order loop vs tiles
    # dominance-pruned by the all-resident energy lower bound
    obs.count("mapper.temporal.tiles_evaluated", n_eval)
    if n_pruned:
        obs.count("mapper.temporal.tiles_pruned", n_pruned)
    if best_key is None:
        return None
    # materialize the winning TemporalChoice exactly as the brute path
    # (enumerate_temporal -> place_loops) would have built it
    (tx, tk, tc, rx, rk, rc, _ti, _tw, _to,
     w0, w1, i0, i1, o0, o1, st, fills) = best_pick
    energy, order = best_key[0], best_key[1]
    trips = {"x": rx, "k": rk, "c": rc}
    inner = order[-1]
    wb = w0 if inner == "x" else w1
    ib = i0 if inner == "k" else i1
    ob = o0 if inner == "c" else o1
    placement = {"weight": st[0], "input": st[1], "output": st[2]}
    level_bytes: Dict[str, int] = {}
    for nbytes, fill in ((wb, fills[0]), (ib, fills[1]), (ob, fills[2])):
        if nbytes:
            level_bytes[fill] = level_bytes.get(fill, 0) + nbytes
    return TemporalChoice(
        order=order, tile_x=tx, tile_k=tk, tile_c=tc,
        sram_bytes=wb + ib + ob,
        pixelwise=_pixelwise_ok(order, trips),
        placement=tuple(sorted(placement.items())),
        level_bytes=tuple(sorted(level_bytes.items())),
        energy_pj=energy)
