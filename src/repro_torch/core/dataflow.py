"""C1 — reconfigurable spatial dataflow model (paper §II, Fig 3).

A 2-D PE array executes one layer as (Spatial X)|(Spatial Y); loops not
spatially unrolled run temporally.  We model three spatial mappings:

  OX|C : the fixed single-dataflow baseline (output-x by input-channel)
  C|K  : input-channel by output-channel (adder-tree reduction down
         columns) — regular/pointwise conv + GEMM
  C|FX : input-channel by kernel-x (row-propagating accumulation) —
         depthwise conv (each group has K=1, so any mapping that unrolls
         K or reduction-C collapses to 1/16 utilization)

``cycles(layer, mapping)`` counts temporal steps with ceil-division over
the spatial dims (spatial under-utilization shows up as lost cycles —
exactly the Fig 3 analysis).  Non-MAC layers (LayerNorm/Softmax) are
bus-streaming stalls unless fused by C2 (see costmodel.LayerCost).

Beyond single dim pairs, the reconfigurable array also supports
*factored* mappings: each array axis takes an ordered tuple of
``(dim, factor)`` unrollings whose factor product fits the axis — e.g.
``4xOX * 4xK`` on a 16-wide row axis.  A dim whose extent is smaller
than the axis no longer strands the remaining PEs (the Fig 3
under-utilization): the residual axis slots replicate onto another
dim's unrolling.  Legality is per axis segment: the accumulation wiring
(segmented adder tree / neighbor propagation) reduces contiguous PE
runs, so a reduction dim must be the innermost (last) factor of its
axis, at most one reduction dim per axis, and a reduction dim never
splits across both axes (no 2-D accumulation).  See
``cycles_factored`` / ``factored_legal``.
"""
from __future__ import annotations

from typing import Dict, Literal, Tuple, Union

from repro_torch.core.workload import DWCONV, MAC_OPS, SCAN, Layer

Mapping = Literal["OXC", "CK", "CFX"]
# generalized spatial mapping: (row_dim, col_dim) — any ordered pair of
# loop dims unrolled over the rows x cols PE array
GenericMapping = Tuple[str, str]
# factored spatial mapping: per array axis an ordered tuple of
# (dim, unroll factor) — the factor product must fit the axis length
FactoredAxis = Tuple[Tuple[str, int], ...]
FactoredMapping = Tuple[FactoredAxis, FactoredAxis]
AnyMapping = Union[Mapping, GenericMapping, FactoredMapping]

SPATIAL_DIMS = ("b", "k", "c", "ox", "oy", "fx", "fy")

# legacy mapping -> (generic dim pair, fixed column wiring).  The fixed
# single-dataflow baseline (OX|C) hard-wires the columns as an adder
# tree; the reconfigurable array can wire either axis either way.
LEGACY_MAPPINGS: Dict[str, Tuple[GenericMapping, bool]] = {
    "OXC": (("ox", "c"), True),
    "CK": (("c", "k"), False),
    "CFX": (("c", "fx"), False),
}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def dim_sizes(layer: Layer) -> Dict[str, int]:
    """Loop-dim extents of a layer.  Depthwise: K=1 per group (the C dim
    counts groups, which act as independent outputs)."""
    return {"b": layer.b, "k": 1 if layer.op == DWCONV else layer.k,
            "c": layer.c, "ox": layer.ox, "oy": layer.oy,
            "fx": layer.fx, "fy": layer.fy}


def reduction_dims(layer: Layer) -> Tuple[str, ...]:
    """Dims whose spatial unrolling needs an accumulation path (adder
    tree / neighbor propagation).  Depthwise: C indexes groups, not a
    reduction — only the kernel window reduces.  Scan: only the state
    key dim reduces (the sequence dim is a carry, never spatial)."""
    if layer.op == SCAN:
        return ("c",)
    return ("fx", "fy") if layer.op == DWCONV else ("c", "fx", "fy")


def cycles_generic(layer: Layer, mapping: GenericMapping, rows: int = 16,
                   cols: int = 16, *, fixed_wiring: bool = False) -> int:
    """Temporal steps for ``layer`` with ``mapping[0]`` unrolled over the
    ``rows`` axis and ``mapping[1]`` over the ``cols`` axis; every other
    loop dim runs temporally (ceil-division models the spatial losses of
    Fig 3).

    A mapping dim the layer does not carry (absent from
    ``dim_sizes`` — e.g. a schedule replayed onto a different op type)
    is a degenerate unrolling of an extent-1 loop: a no-op the temporal
    loops already cover, NOT an error.  Only ``row == col`` is rejected
    (the same loop cannot occupy both axes of one pair mapping — factor
    it instead, see ``cycles_factored``).

    ``fixed_wiring`` models the non-reconfigurable baseline array whose
    column axis is a hard-wired adder tree: unrolling a non-reduction dim
    there is void (one element per tree contributes; the dim runs
    temporally) — this is exactly why the fixed OX|C design collapses to
    1/cols utilization on depthwise layers.
    """
    if layer.op not in MAC_OPS:
        return 0
    rd, cd = mapping
    if rd == cd:
        raise ValueError(f"bad mapping {mapping}")
    sizes = dim_sizes(layer)
    col_void = fixed_wiring and cd not in reduction_dims(layer)
    total = 1
    for d, s in sizes.items():
        if d == rd:
            total *= _ceil(s, rows)
        elif d == cd and not col_void:
            total *= _ceil(s, cols)
        else:
            total *= s
    return total


def is_factored(mapping) -> bool:
    """True for the nested factored form ((dim, f), ...) per axis —
    False for a legacy name or a plain (row_dim, col_dim) pair."""
    return (not isinstance(mapping, str) and len(mapping) == 2
            and all(not isinstance(ax, str) for ax in mapping))


def as_mapping(raw) -> AnyMapping:
    """Canonicalize a JSON-deserialized mapping (nested lists) back to
    the tuple forms ``cycles`` dispatches on: a legacy name string, a
    (row_dim, col_dim) pair, or a factored per-axis tuple."""
    if isinstance(raw, str):
        return raw
    if all(isinstance(x, str) for x in raw):
        return tuple(raw)
    return tuple(tuple((d, int(f)) for d, f in axis) for axis in raw)


def factored_legal(layer: Layer, mapping: FactoredMapping, rows: int = 16,
                   cols: int = 16) -> bool:
    """Reduction-wiring legality of a factored mapping, per axis segment.

    Each axis lays its factors out mixed-radix (last factor fastest
    varying), so only the innermost factor's replicas form contiguous PE
    runs — the segments a segmented adder tree / neighbor-propagation
    chain can reduce.  Hence per axis: at most one reduction dim, and it
    must be the last (innermost) factor.  A reduction dim never splits
    across both axes (the array has no 2-D accumulation wiring), and
    each axis's factor product must fit the axis.
    """
    red = set(reduction_dims(layer))
    red_used = set()
    for axis_len, axis in ((rows, mapping[0]), (cols, mapping[1])):
        prod = 1
        seen = set()
        for i, (d, f) in enumerate(axis):
            if f < 1 or d in seen:
                return False
            seen.add(d)
            prod *= f
            if d in red:
                if d in red_used or i != len(axis) - 1:
                    return False
                red_used.add(d)
        if prod > axis_len:
            return False
    return True


def cycles_factored(layer: Layer, mapping: FactoredMapping,
                    rows: int = 16, cols: int = 16, *,
                    fixed_wiring: bool = False) -> int:
    """Temporal steps under a factored mapping: each axis unrolls its
    ordered (dim, factor) tuple; a dim on both axes multiplies its
    factors (e.g. 4x4 of OX over a 16x16 array); unmapped dims (and
    dims the layer does not carry) run temporally.  A factor product
    smaller than the axis strands the residual PEs — that loss shows up
    in ``spatial_utilization``, not in cycles.

    ``fixed_wiring``: the hard-wired column adder tree sums the whole
    column, so non-reduction column factors are void (the dim runs
    temporally; its replicas would corrupt the tree sum, so those PEs
    idle) — the factored generalization of the pair rule.
    """
    if layer.op not in MAC_OPS:
        return 0
    if not factored_legal(layer, mapping, rows, cols):
        raise ValueError(f"illegal factored mapping {mapping}")
    red = reduction_dims(layer)
    unroll: Dict[str, int] = {}
    for ci, axis in enumerate(mapping):
        for d, f in axis:
            if fixed_wiring and ci == 1 and d not in red:
                continue                       # void column segment
            unroll[d] = unroll.get(d, 1) * f
    total = 1
    for d, s in dim_sizes(layer).items():
        u = unroll.get(d, 1)
        total *= _ceil(s, u) if u > 1 else s
    return total


def _scan_unroll(layer: Layer, mapping: AnyMapping, rows: int, cols: int,
                 *, fixed_wiring: bool = False) -> Dict[str, int]:
    """Per-dim spatial unroll factors of a scan mapping.  Only b / k / c
    may be unrolled — the sequence dim carries the state and must run
    temporally in chunk order."""
    unroll: Dict[str, int] = {}
    axes = mapping if is_factored(mapping) else \
        (((mapping[0], rows),), ((mapping[1], cols),))
    red = reduction_dims(layer)
    for ci, axis in enumerate(axes):
        for d, f in axis:
            if d in ("ox", "oy", "fx", "fy"):
                raise ValueError(
                    f"scan carry/window dim {d!r} cannot be spatial")
            if fixed_wiring and ci == 1 and d not in red:
                continue                       # void column segment
            unroll[d] = unroll.get(d, 1) * f
    return unroll


def cycles_scan(layer: Layer, mapping: AnyMapping, rows: int = 16,
                cols: int = 16, *, chunk: int,
                fixed_wiring: bool = False) -> int:
    """Temporal steps of a SCAN layer executed chunk-by-chunk.

    The sequence dim runs temporally in chunks of ``chunk`` tokens (the
    state carry forbids splitting or reordering it); b / k / c unroll
    spatially per ``mapping``.  Per chunk the four GEMMs of
    ``workload.scan_macs`` run on the array — the [C, C] score and
    intra products put the chunk length on both GEMM sides, so cycles
    grow with the chunk while the chunk count shrinks.  A ragged final
    chunk (T % chunk) is charged its true shorter extent.
    """
    if layer.op != SCAN:
        raise ValueError(f"cycles_scan on {layer.op!r}")
    if chunk < 1:
        raise ValueError(f"bad chunk {chunk}")
    unroll = _scan_unroll(layer, mapping, rows, cols,
                          fixed_wiring=fixed_wiring)
    f_b = min(unroll.get("b", 1), layer.b)
    f_k = min(unroll.get("k", 1), layer.k)
    f_c = min(unroll.get("c", 1), layer.c)
    tk = _ceil(layer.k, f_k)
    tc = _ceil(layer.c, f_c)

    def per_chunk(ct: int) -> int:
        return ct * ct * tc + ct * ct * tk + ct * tk * tc + tc * tk * ct

    nfull, rem = divmod(layer.ox, chunk)
    total = nfull * per_chunk(chunk) + (per_chunk(rem) if rem else 0)
    return _ceil(layer.b, f_b) * total


def scan_utilization(layer: Layer, mapping: AnyMapping, rows: int = 16,
                     cols: int = 16, *, chunk: int,
                     fixed_wiring: bool = False) -> float:
    from repro_torch.core.workload import scan_macs
    cyc = cycles_scan(layer, mapping, rows, cols, chunk=chunk,
                      fixed_wiring=fixed_wiring)
    if cyc == 0:
        return 0.0
    return scan_macs(layer, chunk) / (cyc * rows * cols)


def cycles(layer: Layer, mapping: AnyMapping, rows: int = 16,
           cols: int = 16) -> int:
    """Temporal steps to execute ``layer`` under ``mapping`` on a
    rows x cols PE array (MACs only; returns 0 for non-MAC ops).

    ``mapping`` is a legacy name ("OXC" | "CK" | "CFX"), a generic
    (row_dim, col_dim) pair (see ``cycles_generic``), or a factored
    per-axis ((dim, factor), ...) assignment (see ``cycles_factored``).
    """
    if isinstance(mapping, str):
        pair, fixed = LEGACY_MAPPINGS[mapping]
        return cycles_generic(layer, pair, rows, cols, fixed_wiring=fixed)
    if is_factored(mapping):
        return cycles_factored(layer, mapping, rows, cols)
    return cycles_generic(layer, mapping, rows, cols)


def mapping_label(mapping: AnyMapping) -> str:
    """Display form: "OX|C" for pairs (and legacy names verbatim),
    "4xOX*4xK|16xC" for factored mappings."""
    if isinstance(mapping, str):
        return mapping
    if is_factored(mapping):
        return "|".join(
            "*".join(f"{f}x{d.upper()}" for d, f in axis) or "-"
            for axis in mapping)
    return "|".join(mapping).upper()


def select_mapping(layer: Layer, *, reconfigurable: bool) -> Mapping:
    """The paper's per-layer dataflow selector.

    Fixed design: everything on OX|C.  Reconfigurable design: C|K for
    conv/pointwise/GEMM, C|FX for depthwise — ``C|(K v FX)`` in the paper.
    """
    if not reconfigurable:
        return "OXC"
    return "CFX" if layer.op == DWCONV else "CK"


def spatial_utilization(layer: Layer, mapping: AnyMapping, rows: int = 16,
                        cols: int = 16) -> float:
    cyc = cycles(layer, mapping, rows, cols)
    if cyc == 0:
        return 0.0
    return layer.macs / (cyc * rows * cols)
