"""Static verification of ``Schedule`` artifacts, from first principles.

This module re-derives every legality and cost invariant a schedule
claims — tile footprints vs memory budgets, spatial-mapping rules,
fusion-chain rules, per-level traffic and energy conservation —
directly from ``Layer`` shapes, the artifact's embedded
``MemoryHierarchy``, and the artifact fields themselves.  It shares
**no helper** with the mapper / tiler / partitioner / cost model: the
cycle formulas, traffic rows, and budget rules below are independent
re-implementations, so a bug in the search stack shows up as a finding
here instead of being blessed by the code that produced it.

Entry points:

  ``check_schedule(layers, sched)``  — verify a live Schedule object
  ``check_doc(doc, layers=None)``    — verify a raw artifact dict
                                       (partial docs — e.g. the pinned
                                       goldens — are fine: each check
                                       guards on field presence)

Both return a list of ``Finding``s (empty == the artifact is clean).
Degraded schedules (``degraded="nearest_batch"``) keep the identity
conservation tier (edp == energy x latency survives linear rescaling)
but skip the absolute re-derivation, whose inputs no longer describe
the decisions that priced them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.memory import MemoryHierarchy
from repro_torch.core.workload import (MAC_OPS, SCAN, Layer, scan_macs,
                                 scan_state_bytes)

KNOWN_VERSIONS = (6,)

_DIM_NAMES = ("b", "k", "c", "ox", "oy", "fx", "fy")
_OPERANDS = ("input", "weight", "output")
# legacy named mappings carry their own fixed-wiring flag
_LEGACY = {"OXC": (("ox", "c"), True),
           "CK": (("c", "k"), False),
           "CFX": (("c", "fx"), False)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant: a machine-readable code, the layer /
    group / cost key it anchors to, and a human-readable detail."""
    code: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"{self.code} @ {self.where}: {self.detail}"


def _ceil(a: int, b: int) -> int:
    return -(-int(a) // max(1, int(b)))


def _close(a: float, b: float, rel: float = 1e-6) -> bool:
    return math.isclose(float(a), float(b), rel_tol=rel, abs_tol=1e-12)


def _is_mac(l: Layer) -> bool:
    return l.op in MAC_OPS


def _is_compute(l: Layer) -> bool:
    return l.op in MAC_OPS or l.op == SCAN


def _dim_sizes(l: Layer) -> Dict[str, int]:
    return {"b": l.b, "k": 1 if l.op == "dwconv" else l.k, "c": l.c,
            "ox": l.ox, "oy": l.oy, "fx": l.fx, "fy": l.fy}


def _reduction_dims(l: Layer) -> Tuple[str, ...]:
    if l.op == SCAN:
        return ("c",)
    if l.op == "dwconv":
        return ("fx", "fy")
    return ("c", "fx", "fy")


def _norm_mapping(v):
    """Normalize a mapping from either live (tuple) or JSON (list)
    form: a legacy name string, a ``(row_dim, col_dim)`` pair, or the
    factored per-axis ``(((dim, factor), ...), ...)`` form."""
    if isinstance(v, str):
        return v
    seq = tuple(v)
    if len(seq) == 2 and all(isinstance(a, str) for a in seq):
        return (seq[0], seq[1])
    return tuple(tuple((str(d), int(f)) for d, f in axis) for axis in seq)


# ---------------------------------------------------------------------------
# independent cycle formulas (cross-check of core.dataflow)
# ---------------------------------------------------------------------------


def _pair_cycles(l: Layer, rd: str, cd: str, rows: int, cols: int,
                 fixed_wiring: bool) -> int:
    red = _reduction_dims(l)
    col_void = fixed_wiring and cd not in red
    total = 1
    for d, s in _dim_sizes(l).items():
        if d == rd:
            total *= _ceil(s, rows)
        elif d == cd and not col_void:
            total *= _ceil(s, cols)
        else:
            total *= s
    return total


def _factored_cycles(l: Layer, m, fixed_wiring: bool) -> int:
    red = _reduction_dims(l)
    unroll: Dict[str, int] = {}
    for ai, axis in enumerate(m):
        for d, f in axis:
            if ai == 1 and fixed_wiring and d not in red:
                continue        # fixed column wiring voids the factor
            unroll[d] = unroll.get(d, 1) * int(f)
    total = 1
    for d, s in _dim_sizes(l).items():
        u = unroll.get(d, 1)
        total *= _ceil(s, u) if u > 1 else s
    return total


def _scan_cycles(l: Layer, m, chunk: int, rows: int, cols: int,
                 fixed_wiring: bool) -> int:
    if isinstance(m, tuple) and len(m) == 2 \
            and all(isinstance(x, str) for x in m):
        axes = (((m[0], rows),), ((m[1], cols),))
    else:
        axes = m
    unroll: Dict[str, int] = {}
    for ai, axis in enumerate(axes):
        for d, f in axis:
            if ai == 1 and fixed_wiring and d != "c":
                continue
            unroll[d] = unroll.get(d, 1) * int(f)
    f_b = min(unroll.get("b", 1), l.b)
    f_k = min(unroll.get("k", 1), l.k)
    f_c = min(unroll.get("c", 1), l.c)
    tk, tc = _ceil(l.k, f_k), _ceil(l.c, f_c)

    def per(ct: int) -> int:
        return ct * ct * tc + ct * ct * tk + ct * tk * tc + tc * tk * ct

    nfull, rem = divmod(l.ox, chunk)
    return _ceil(l.b, f_b) * (nfull * per(chunk) + (per(rem) if rem else 0))


# ---------------------------------------------------------------------------
# doc plumbing
# ---------------------------------------------------------------------------


def _schedule_doc(sched) -> dict:
    if isinstance(sched, dict):
        return sched
    return dataclasses.asdict(sched)


def _hier_of(doc) -> Optional[MemoryHierarchy]:
    hw = doc.get("hw")
    if not isinstance(hw, dict) or "hierarchy" not in hw:
        return None
    try:
        return MemoryHierarchy.from_json(hw["hierarchy"])
    except (KeyError, TypeError, ValueError):
        return None


def _group_spans(groups) -> List[Tuple[int, int]]:
    spans, pos = [], 0
    for g in groups:
        spans.append((pos, pos + len(g)))
        pos += len(g)
    return spans


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def _check_structure(doc, layers, findings: List[Finding]) -> bool:
    """Version, chain tiling, name-keyed field domains.  Returns False
    when the chain itself is broken (deeper checks would be noise)."""
    if "version" in doc and doc["version"] not in KNOWN_VERSIONS:
        findings.append(Finding("structure.version", "version",
                                f"unknown search version {doc['version']}"))
    names = [l.name for l in layers]
    if len(set(names)) != len(names):
        findings.append(Finding("structure.duplicate_names", "chain",
                                "request layer names are not unique"))
        return False
    groups = doc.get("groups")
    if groups is not None:
        flat = [n for g in groups for n in g]
        if flat != names:
            findings.append(Finding(
                "structure.groups_chain", "groups",
                "group tuples do not tile the layer chain in order"))
            return False
    by_name = {l.name: l for l in layers}
    for field in ("mappings", "orders", "placements", "tiles"):
        extra = set(doc.get(field) or {}) - set(names)
        if extra:
            findings.append(Finding(
                f"structure.{field}_domain", field,
                f"keys outside the chain: {sorted(extra)}"))
    mappings = doc.get("mappings")
    if mappings is not None:
        missing = [n for n, l in by_name.items()
                   if _is_compute(l) and n not in mappings]
        if missing:
            findings.append(Finding(
                "structure.mapping_missing", ",".join(sorted(missing)),
                "compute layer without a spatial mapping"))
    for n, order in (doc.get("orders") or {}).items():
        # temporal macro-loops: a permutation of (x | pixels,
        # k | output channels, c | reduction)
        if sorted(order) != ["c", "k", "x"]:
            findings.append(Finding(
                "structure.order", n,
                f"loop order {tuple(order)} is not a permutation"
                " of ('x', 'k', 'c')"))
    return True


def _check_placements(doc, layers, hier, findings: List[Finding]) -> None:
    if hier is None:
        return
    valid = set(hier.names)
    for n, pl in (doc.get("placements") or {}).items():
        for op, lvl in dict(pl).items():
            if op not in _OPERANDS + ("state",):
                findings.append(Finding("placement.operand", n,
                                        f"unknown operand {op!r}"))
            if lvl not in valid:
                findings.append(Finding(
                    "placement.level", n,
                    f"placement level {lvl!r} not in hierarchy"))


# ---------------------------------------------------------------------------
# spatial-mapping legality
# ---------------------------------------------------------------------------


def _check_spatial(doc, layers, findings: List[Finding]) -> None:
    mappings = doc.get("mappings")
    if mappings is None:
        return
    hw = doc.get("hw") or {}
    limits = (int(hw.get("rows", 0)) or None, int(hw.get("cols", 0)) or None)
    by_name = {l.name: l for l in layers}
    for name, raw in mappings.items():
        l = by_name.get(name)
        if l is None:
            continue
        try:
            m = _norm_mapping(raw)
        except (TypeError, ValueError):
            findings.append(Finding("spatial.malformed", name,
                                    f"unparseable mapping {raw!r}"))
            continue
        red = _reduction_dims(l)
        if isinstance(m, str):
            if m not in _LEGACY:
                findings.append(Finding("spatial.legacy_unknown", name,
                                        f"unknown legacy mapping {m!r}"))
            continue
        if isinstance(m[0], str):               # (row_dim, col_dim) pair
            rd, cd = m
            dims_used = (rd, cd)
            if rd == cd:
                findings.append(Finding(
                    "spatial.pair_same_dim", name,
                    f"row and column both map {rd!r}"))
        else:                                   # factored per-axis form
            dims_used = tuple(d for axis in m for d, _ in axis)
            for ai, axis in enumerate(m):
                limit = limits[ai] if ai < 2 else None
                seen, prod = set(), 1
                for d, f in axis:
                    if f < 1:
                        findings.append(Finding(
                            "spatial.bad_factor", name,
                            f"factor {f} < 1 on dim {d!r}"))
                    if d in seen:
                        findings.append(Finding(
                            "spatial.dup_dim", name,
                            f"dim {d!r} appears twice on one axis"))
                    seen.add(d)
                    prod *= max(1, int(f))
                if limit and prod > limit:
                    findings.append(Finding(
                        "spatial.axis_overflow", name,
                        f"axis {ai} unroll {prod} exceeds {limit} PEs"))
            for rdim in red:
                hits = [(ai, i) for ai, axis in enumerate(m)
                        for i, (d, _) in enumerate(axis) if d == rdim]
                if len(hits) > 1:
                    findings.append(Finding(
                        "spatial.reduction_split", name,
                        f"reduction dim {rdim!r} split across segments"))
                elif hits:
                    ai, i = hits[0]
                    if i != len(m[ai]) - 1:
                        findings.append(Finding(
                            "spatial.reduction_not_innermost", name,
                            f"reduction dim {rdim!r} is not the"
                            " innermost factor of its axis"))
        bad = [d for d in dims_used if d not in _DIM_NAMES]
        if bad:
            findings.append(Finding("spatial.unknown_dim", name,
                                    f"unknown dims {bad}"))
        if l.op == SCAN:
            split = [d for d in dims_used if d not in ("b", "k", "c")]
            if split:
                findings.append(Finding(
                    "spatial.scan_carry_split", name,
                    f"scan carry/sequence dims {split} spatially split"))


# ---------------------------------------------------------------------------
# fusion legality
# ---------------------------------------------------------------------------


def _chain_compatible(a: Layer, b: Layer) -> bool:
    return (a.op in ("pwconv", "matmul") and b.op in ("pwconv", "matmul")
            and a.b * a.ox * a.oy == b.b * b.ox * b.oy and a.k == b.c)


def _check_fusion(doc, layers, hier, findings: List[Finding]) -> None:
    groups = doc.get("groups")
    if groups is None:
        return
    by_name = {l.name: l for l in layers}
    fused = doc.get("fused_nonlinear")
    fused_set = set(fused) if fused is not None else None
    expected_fused = set()
    for g in groups:
        members = [by_name[n] for n in g]
        comp = [l for l in members if _is_compute(l)]
        scans = [l for l in comp if l.op == SCAN]
        if scans and len(comp) > 1:
            findings.append(Finding(
                "fusion.scan_isolation", scans[0].name,
                "scan fused with other compute layers"))
        macs = [l for l in comp if _is_mac(l)]
        if len(macs) >= 2:
            for a, b in zip(macs, macs[1:]):
                if not _chain_compatible(a, b):
                    findings.append(Finding(
                        "fusion.chain_incompatible", f"{a.name}->{b.name}",
                        "fused MAC pair is not a compatible"
                        " pwconv/matmul chain"))
        seen = False
        tail = []
        for l in members:
            if _is_compute(l):
                seen = True
            elif seen:
                expected_fused.add(l.name)
                tail.append(l)
        if scans and tail and hier is not None:
            budget = max((lvl.serve_capacity("output")
                          for lvl in hier.local_levels()), default=0)
            sb = scan_state_bytes(scans[0])
            if sb > budget:
                findings.append(Finding(
                    "fusion.scan_state_overflow", scans[0].name,
                    f"carry state {sb}B exceeds every local level"
                    f" budget ({budget}B) yet the tail is fused"))
    if fused_set is not None:
        ghost = fused_set - expected_fused
        lost = expected_fused - fused_set
        if ghost:
            findings.append(Finding(
                "fusion.fused_not_interior", ",".join(sorted(ghost)),
                "marked fused but not after a compute layer in a group"))
        if lost:
            findings.append(Finding(
                "fusion.interior_not_fused", ",".join(sorted(lost)),
                "follows a compute layer inside a group but is not"
                " marked fused"))


# ---------------------------------------------------------------------------
# spill edges
# ---------------------------------------------------------------------------


def _expected_edges(layers, groups, hier) -> List[Tuple[int, int, int]]:
    budget = hier.act_budget_bytes
    spans = _group_spans(groups)
    out = []
    for gi in range(len(spans) - 1):
        s, e = spans[gi]
        ns, ne = spans[gi + 1]
        nbytes = layers[e - 1].output_bytes
        if nbytes <= budget:
            continue
        prod = next((i for i in range(e - 1, s - 1, -1)
                     if _is_compute(layers[i])), e - 1)
        cons = next((i for i in range(ns, ne)
                     if _is_compute(layers[i])), ns)
        out.append((prod, cons, nbytes))
    return out


def _check_edges(doc, layers, hier, findings: List[Finding],
                 degraded) -> None:
    edges = doc.get("edges")
    if edges is None:
        return
    norm = []
    for e in edges:
        p, c, nb = (int(x) for x in e)
        if not (0 <= p < c < len(layers)):
            findings.append(Finding("edges.indices", str(tuple(e)),
                                    "edge endpoints out of range/order"))
            return
        norm.append((p, c, nb))
    if hier is None or doc.get("groups") is None or degraded is not None:
        # a nearest-batch rescale carries the neighbor batch's edge
        # bytes — only the index structure is checkable here
        return
    want = _expected_edges(layers, doc["groups"], hier)
    want_set = set(want)
    for e in norm:
        if e not in want_set:
            findings.append(Finding(
                "edges.invalid", f"{layers[e[0]].name}->{layers[e[1]].name}",
                f"edge {e} does not match any over-budget group"
                " boundary"))
    if set(norm) != want_set:
        missing = want_set - set(norm)
        for e in sorted(missing):
            findings.append(Finding(
                "edges.missing", f"{layers[e[0]].name}->{layers[e[1]].name}",
                f"over-budget group boundary ({e[2]}B >"
                f" {hier.act_budget_bytes}B act budget) has no spill"
                " edge"))


# ---------------------------------------------------------------------------
# tile footprints vs budgets
# ---------------------------------------------------------------------------


def _expected_group_tile(macs: List[Layer], tx: int, tc: int) -> dict:
    """Re-derive the fused-group tile stats the tiler should have
    recorded for tile sizes (tx, tc) — buffer footprint (ragged last
    tile included via the ceil-division reread counts), weight rereads,
    and the SRAM traffic the tile plan implies."""
    if len(macs) == 2:
        expand, project = macs
        n = expand.b * expand.ox * expand.oy
        c_in, c_mid, c_out = expand.c, expand.k, project.k
        bpb = max(1, expand.bits // 8)
        w_bytes = (c_in * c_mid + c_mid * c_out) * bpb
        return {"buffer_bytes": tx * tc * bpb,
                "ragged_x": n % tx, "ragged_c": c_mid % tc,
                "weight_rereads": _ceil(n, tx),
                "sram_traffic": (_ceil(c_mid, tc) * n * c_in * bpb
                                 + _ceil(n, tx) * w_bytes
                                 + n * c_out * bpb)}
    n = macs[0].b * macs[0].ox * macs[0].oy
    bpb = max(1, macs[0].bits // 8)
    widths = [m.k for m in macs[:-1]]
    peak = (max(a + b for a, b in zip(widths, widths[1:]))
            if len(widths) > 1 else widths[0])
    return {"buffer_bytes": tx * peak * bpb,
            "ragged_x": n % tx, "ragged_c": 0,
            "weight_rereads": _ceil(n, tx),
            "sram_traffic": (_ceil(n, tx)
                             * sum(m.weight_bytes for m in macs)
                             + macs[0].input_bytes
                             + macs[-1].output_bytes)}


def _check_tiles(doc, layers, hier, findings: List[Finding],
                 degraded=None) -> None:
    groups = doc.get("groups")
    tiles = doc.get("tiles")
    if tiles is None:
        return
    by_name = {l.name: l for l in layers}
    placements = doc.get("placements") or {}
    local = {lvl.name: lvl for lvl in hier.local_levels()} if hier else {}
    for name, t in tiles.items():
        l = by_name.get(name)
        if l is None:
            continue
        if "chunk" in t:                        # scan state tile
            chunk = int(t["chunk"])
            if chunk < 1:
                findings.append(Finding("tiles.scan_chunk", name,
                                        f"chunk {chunk} < 1"))
            sb = scan_state_bytes(l)
            if int(t.get("state_bytes", sb)) != sb:
                findings.append(Finding(
                    "tiles.scan_state_bytes", name,
                    f"recorded state {t.get('state_bytes')}B !="
                    f" 4*c*k = {sb}B"))
            if hier is not None and "level" in t:
                want = hier.stationary_level("output", sb).name
                if t["level"] != want:
                    findings.append(Finding(
                        "tiles.scan_state_level", name,
                        f"state pinned at {t['level']!r}, first level"
                        f" fitting {sb}B is {want!r}"))
                state_pl = dict(placements.get(name, {})).get("state")
                if state_pl is not None and state_pl != t["level"]:
                    findings.append(Finding(
                        "tiles.scan_state_placement", name,
                        f"placement {state_pl!r} != tile level"
                        f" {t['level']!r}"))
            continue
        if "tile_x" not in t:
            continue
        if degraded == "nearest_batch":
            # the tile was optimized for the neighbor batch's pixel
            # count; its byte-exact stats are not re-derivable here
            continue
        group = next((g for g in (groups or ()) if name in g), None)
        macs = ([by_name[n] for n in group if _is_mac(by_name[n])]
                if group else [l])
        if not group or len(macs) < 2 or name != macs[0].name:
            findings.append(Finding(
                "tiles.head", name,
                "group tile recorded outside a multi-MAC group head"))
            continue
        tx, tc = int(t["tile_x"]), int(t.get("tile_c", 0))
        if tx < 1 or tc < 1:
            findings.append(Finding("tiles.degenerate", name,
                                    f"tile ({tx}, {tc}) not positive"))
            continue
        want = _expected_group_tile(macs, tx, tc)
        for field in ("buffer_bytes", "ragged_x", "ragged_c",
                      "weight_rereads", "sram_traffic"):
            if field in t and int(t[field]) != int(want[field]):
                findings.append(Finding(
                    f"tiles.{field}", name,
                    f"recorded {t[field]} != re-derived"
                    f" {want[field]} for tile ({tx}, {tc})"))
        if hier is not None and "level" in t:
            lvl = local.get(t["level"])
            if lvl is None:
                findings.append(Finding(
                    "tiles.level", name,
                    f"fused intermediates pinned at {t['level']!r},"
                    " which is not an on-chip (local) level"))
            elif int(t.get("buffer_bytes", want["buffer_bytes"])) \
                    > lvl.serve_capacity("output"):
                findings.append(Finding(
                    "tiles.budget_overflow", name,
                    f"tile footprint {t.get('buffer_bytes')}B exceeds"
                    f" {lvl.name} budget"
                    f" {lvl.serve_capacity('output')}B"))
    if groups is not None:
        for g in groups:
            macs = [n for n in g if _is_mac(by_name[n])]
            if len(macs) >= 2 and "tile_x" not in (tiles.get(macs[0])
                                                   or {}):
                findings.append(Finding(
                    "tiles.missing", macs[0],
                    "multi-MAC fused group has no tile record"))


# ---------------------------------------------------------------------------
# conservation: re-derive the cost dict from the decisions alone
# ---------------------------------------------------------------------------


def _mac_mapping_cycles(l, m, rows, cols, fixed_wiring):
    if isinstance(m, str):
        pair, legacy_fixed = _LEGACY[m]
        return _pair_cycles(l, pair[0], pair[1], rows, cols, legacy_fixed)
    if isinstance(m[0], str):
        return _pair_cycles(l, m[0], m[1], rows, cols, fixed_wiring)
    return _factored_cycles(l, m, fixed_wiring)


def _expected_network_cost(layers, doc, hier, *, tile_aware: bool):
    """Independent re-evaluation of the schedule: per-layer cycles,
    per-level traffic rows, and the energy-bucket roll-up, computed
    from the artifact's decisions and the Layer shapes alone.  Returns
    ``(latency_s, energy_j, dram_bytes, stream_bytes)``."""
    hw = doc["hw"]
    rows, cols = int(hw["rows"]), int(hw["cols"])
    clock = float(hw["clock_hz"])
    e_mac = float(hw["e_mac"])
    static_mw = float(hw["static_mw"])
    fixed = bool(doc.get("fixed_wiring", False))
    bus = max(1, hier.outermost.bus_bytes_per_cycle)
    stream = hier.levels[1].name
    inner = hier.innermost.name
    outer = hier.outermost.name
    fused = set(doc.get("fused_nonlinear") or ())
    by_name = {l.name: l for l in layers}
    mappings = {k: _norm_mapping(v)
                for k, v in (doc.get("mappings") or {}).items()}
    placements = doc.get("placements") or {}
    tiles = doc.get("tiles") or {}
    extra: Dict[str, int] = {}
    for p, c, nb in (doc.get("edges") or ()):
        extra[layers[int(p)].name] = extra.get(layers[int(p)].name, 0) \
            + int(nb)
        extra[layers[int(c)].name] = extra.get(layers[int(c)].name, 0) \
            + int(nb)
    overrides: Dict[str, int] = {}
    if tile_aware:
        for g in (doc.get("groups") or ()):
            macs = [n for n in g if _is_mac(by_name[n])]
            if len(macs) < 2:
                continue
            t = tiles.get(macs[0])
            if not t or "sram_traffic" not in t:
                continue
            overrides[macs[0]] = int(t["sram_traffic"])
            for n in macs[1:]:
                overrides[n] = 0

    rows_out = []            # (cycles, traffic, extra_macs) per layer
    for l in layers:
        xd = extra.get(l.name, 0)
        traffic: Dict[str, float] = {}

        def add(level: str, n) -> None:
            if n:
                traffic[level] = traffic.get(level, 0.0) + float(n)

        if l.op == SCAN:
            m = mappings.get(l.name, ("k", "c"))
            chunk = int((tiles.get(l.name) or {}).get("chunk", 64))
            cyc = _scan_cycles(l, m, chunk, rows, cols, fixed)
            total_macs = scan_macs(l, chunk)
            add(inner, 4 * (total_macs // max(cols, 1) + l.output_elems))
            sb = scan_state_bytes(l)
            add(hier.stationary_level("output", sb).name,
                2 * sb * l.b * _ceil(l.ox, chunk))
            add(stream, l.input_bytes + l.output_bytes + l.weight_bytes)
            dram = l.weight_bytes + xd
            add(outer, dram)
            stall = max(0, math.ceil(dram / bus) - cyc)
            rows_out.append((cyc + stall, traffic, total_macs - l.macs))
        elif not _is_mac(l):
            if l.name in fused:
                rows_out.append((0, {}, 0))
                continue
            nb = l.input_bytes
            passes = 2 if l.op in ("norm", "softmax") else 1
            add(inner, nb)
            add(stream, passes * 2 * nb)
            add(outer, xd)
            stall = passes * math.ceil(2 * nb / bus) \
                + math.ceil(xd / bus)
            rows_out.append((stall, traffic, 0))
        else:
            m = mappings.get(l.name, "OXC")
            cyc = _mac_mapping_cycles(l, m, rows, cols, fixed)
            add(inner, 4 * (l.macs // max(cols, 1) + l.output_elems))
            ov = overrides.get(l.name)
            if ov is not None:
                add(stream, ov)
            else:
                pl = placements.get(l.name)
                if pl is not None:
                    for op, nb in (("input", l.input_bytes),
                                   ("output", l.output_bytes),
                                   ("weight", l.weight_bytes)):
                        lvl = hier.fill_for_placement(
                            op, dict(pl).get(op, stream))
                        add(lvl.name, nb)
                else:
                    add(stream, l.input_bytes + l.output_bytes
                        + l.weight_bytes)
            dram = l.weight_bytes + xd
            add(outer, dram)
            stall = max(0, math.ceil(dram / bus) - cyc)
            rows_out.append((cyc + stall, traffic, 0))

    total_cycles = sum(c for c, _, _ in rows_out)
    latency = total_cycles / clock
    pj_by = {lvl.name: lvl.pj_per_byte for lvl in hier.levels}
    compute = 0.0
    tot: Dict[str, float] = {}
    for l, (_, traffic, extra_macs) in zip(layers, rows_out):
        compute += (l.macs + extra_macs) * e_mac
        for k, v in traffic.items():
            tot[k] = tot.get(k, 0.0) + v * pj_by[k]
    energy_pj = sum(tot.values()) + compute \
        + static_mw * 1e-3 * latency * 1e12
    dram_bytes = sum(t.get(outer, 0.0) for _, t, _ in rows_out)
    stream_bytes = sum(t.get(stream, 0.0) for _, t, _ in rows_out)
    return latency, energy_pj * 1e-12, dram_bytes, stream_bytes


def _check_cost(doc, layers, hier, findings: List[Finding],
                degraded) -> None:
    cost = doc.get("cost")
    if not cost:
        return
    for k, v in cost.items():
        if not math.isfinite(float(v)):
            findings.append(Finding("cost.nonfinite", k,
                                    f"{k} = {v!r}"))
            return
    for k in ("latency_s", "energy_j", "edp", "fps",
              "energy_tiled_j", "edp_tiled"):
        if k in cost and float(cost[k]) <= 0:
            findings.append(Finding("cost.nonpositive", k,
                                    f"{k} = {cost[k]}"))
    if "spatial_util" in cost and not (
            0.0 <= float(cost["spatial_util"]) <= 1.0 + 1e-9):
        findings.append(Finding("cost.spatial_util", "spatial_util",
                                f"utilization {cost['spatial_util']}"
                                " outside [0, 1]"))
    # identity tier: survives any *linear* degraded rescale by design
    if all(k in cost for k in ("edp", "energy_j", "latency_s")):
        if not _close(cost["edp"],
                      cost["energy_j"] * cost["latency_s"]):
            findings.append(Finding(
                "cost.edp_identity", "edp",
                f"edp {cost['edp']} != energy_j x latency_s"
                f" = {cost['energy_j'] * cost['latency_s']}"))
    if all(k in cost for k in ("fps", "latency_s")):
        if not _close(cost["fps"] * cost["latency_s"], 1.0):
            findings.append(Finding(
                "cost.fps_identity", "fps",
                f"fps x latency_s = "
                f"{cost['fps'] * cost['latency_s']} != 1"))
    if all(k in cost for k in ("edp_tiled", "energy_tiled_j",
                               "latency_s")):
        if not _close(cost["edp_tiled"],
                      cost["energy_tiled_j"] * cost["latency_s"]):
            findings.append(Finding(
                "cost.edp_tiled_identity", "edp_tiled",
                "edp_tiled != energy_tiled_j x latency_s"))
    # absolute tier: full re-derivation (meaningless for a schedule
    # whose cost was rescaled from a different batch's decisions)
    if degraded == "nearest_batch":
        return
    if hier is None or doc.get("mappings") is None \
            or doc.get("groups") is None or "hw" not in doc:
        return
    lat, en, dram, _ = _expected_network_cost(layers, doc, hier,
                                              tile_aware=False)
    for key, want in (("latency_s", lat), ("energy_j", en),
                      ("edp", en * lat), ("fps", 1.0 / lat),
                      ("dram_bytes", dram)):
        if key in cost and not _close(cost[key], want):
            findings.append(Finding(
                "cost.conservation", key,
                f"recorded {cost[key]} != re-derived {want}"))
    if any(k in cost for k in ("energy_tiled_j", "edp_tiled",
                               "sram_tiled_bytes")):
        lat_t, en_t, _, sram_t = _expected_network_cost(
            layers, doc, hier, tile_aware=True)
        for key, want in (("energy_tiled_j", en_t),
                          ("edp_tiled", en_t * lat_t),
                          ("sram_tiled_bytes", sram_t)):
            if key in cost and not _close(cost[key], want):
                findings.append(Finding(
                    "cost.conservation_tiled", key,
                    f"recorded {cost[key]} != re-derived {want}"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_doc(doc: dict, layers: Optional[Sequence[Layer]] = None, *,
              degraded: Optional[str] = None) -> List[Finding]:
    """Verify a raw artifact document (possibly partial — each check
    guards on field presence).  ``layers`` defaults to the registered
    workload named in the doc."""
    findings: List[Finding] = []
    if layers is None:
        name = doc.get("workload")
        if not name:
            return [Finding("structure.workload", "workload",
                            "no layers given and no workload name")]
        from repro_torch.search import get_workload
        try:
            layers = get_workload(name)
        except KeyError:
            return [Finding("structure.workload", str(name),
                            "workload not in the registry")]
    layers = list(layers)
    hier = _hier_of(doc)
    if not _check_structure(doc, layers, findings):
        return findings
    _check_placements(doc, layers, hier, findings)
    _check_spatial(doc, layers, findings)
    _check_fusion(doc, layers, hier, findings)
    if hier is not None:
        _check_tiles(doc, layers, hier, findings, degraded)
    _check_edges(doc, layers, hier, findings, degraded)
    _check_cost(doc, layers, hier, findings, degraded)
    return findings


def check_schedule(layers: Sequence[Layer], sched, *,
                   degraded: Optional[str] = None) -> List[Finding]:
    """Verify a live ``Schedule`` against the request's layers.  The
    ``degraded`` marker (a dynamic attribute, never serialized) relaxes
    only what a degraded answer genuinely cannot satisfy."""
    if degraded is None:
        degraded = getattr(sched, "degraded", None)
    return check_doc(_schedule_doc(sched), layers, degraded=degraded)
