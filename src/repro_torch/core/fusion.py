"""C3 — inverted-bottleneck layer fusion (paper §IV, Figs 4-5).

The IBN structure ``pw-expand -> act -> pw-project`` creates a 4x-expanded
intermediate T.  Unfused, T exceeds on-chip SRAM for the early stages and
round-trips through DRAM (the paper attributes 63.6% of all EdgeNeXt-S
DRAM transfers to this).  The fusion executes the two pointwise layers
depth-first: T is tiled along (X, C); each tile t1 is produced into local
memory, immediately consumed into partial sums of the output tile o1, and
discarded.

Traffic is modeled on *edges* of the (linear) layer chain: the tensor
between layers i and i+1 spills to DRAM iff it exceeds the on-chip
activation budget, costing one write (producer) and one read (consumer).
Fusions delete edges:
  C2 (pixelwise nonlinear fusion): a fused norm/softmax/act/residual layer
     consumes its input inside the producer's writeback buffer — its input
     edge disappears; its output edge re-attaches to the producer.
  C3 (IBN fusion): the expand->act and act->project edges disappear
     (T lives only in the local buffer).

``optimize_tile`` is the ZigZag-style tile-size search for the fused pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tiling import budget_tile_candidates
from repro_torch.core.workload import MAC_OPS, Layer


@dataclasses.dataclass(frozen=True)
class SpillEdge:
    producer: int     # layer index writing the tensor
    consumer: int     # layer index reading it back
    nbytes: int
    is_ibn: bool      # part of an inverted-bottleneck intermediate


def spill_edges(layers: List[Layer], act_sram_budget: int,
                *, fuse_nonlinear: bool, fuse_ibn: bool) -> List[SpillEdge]:
    """Edges whose tensor round-trips DRAM under the given fusion config.

    With C2 on, a run of nonlinear layers melts into its producing MAC
    layer: the edge goes producer-MAC -> next-MAC, with the tensor sized
    after the last fused nonlinear (same element count).  Without C2 every
    adjacent pair is an edge.
    """
    n = len(layers)
    edges: List[SpillEdge] = []
    for i in range(n - 1):
        l = layers[i]
        if fuse_nonlinear and l.op not in MAC_OPS:
            continue        # this tensor is owned by its producing MAC layer
        if fuse_nonlinear:
            j = i + 1
            while j < n and layers[j].op not in MAC_OPS:
                j += 1
            if j >= n:
                break
            tensor_bytes = layers[j - 1].output_bytes
        else:
            j = i + 1
            tensor_bytes = l.output_bytes
        if tensor_bytes <= act_sram_budget:
            continue
        is_ibn = l.ibn_role in ("expand", "act")
        if fuse_ibn and is_ibn:
            continue                    # T never materializes (depth-first)
        edges.append(SpillEdge(producer=i, consumer=j,
                               nbytes=tensor_bytes, is_ibn=is_ibn))
    return edges


def spill_bytes_per_layer(layers: List[Layer], edges: List[SpillEdge]
                          ) -> Dict[str, int]:
    """DRAM bytes charged per layer name (write at producer, read at
    consumer)."""
    out: Dict[str, int] = {}
    for e in edges:
        pn = layers[e.producer].name
        cn = layers[e.consumer].name
        out[pn] = out.get(pn, 0) + e.nbytes
        out[cn] = out.get(cn, 0) + e.nbytes
    return out


def ibn_dram_share(layers: List[Layer], act_sram_budget: int) -> float:
    """Fraction of unfused DRAM traffic attributable to IBN intermediates
    (the paper reports 63.6% for EdgeNeXt-S).  Baseline schedule =
    pixelwise fusion on (the paper measures IBN share on the §III design),
    IBN fusion off."""
    edges = spill_edges(layers, act_sram_budget, fuse_nonlinear=True,
                        fuse_ibn=False)
    weight_dram = sum(l.weight_bytes for l in layers)
    act_dram = sum(2 * e.nbytes for e in edges)
    ibn = sum(2 * e.nbytes for e in edges if e.is_ibn)
    total = weight_dram + act_dram
    return ibn / total if total else 0.0


# ---------------------------------------------------------------------------
# Tile-size optimization (ZigZag-style exhaustive search, small space)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedTile:
    tile_x: int          # pixels per tile
    tile_c: int          # expanded channels per tile
    buffer_bytes: int    # live T tile
    weight_rereads: int  # times W1/W2 are re-read from SRAM (x rounds,
    #                      ragged round included)
    sram_traffic: int    # total SRAM bytes moved for the fused pair
    ragged_x: int = 0    # size of the ragged last x tile (0 = perfect)
    ragged_c: int = 0    # size of the ragged last c tile (0 = perfect)


def optimize_tile(expand: Layer, project: Layer, *, local_buffer,
                  candidates_x: Optional[Tuple[int, ...]] = None,
                  full_width: bool = False,
                  mode: str = "full") -> FusedTile:
    """Pick (tile_x, tile_c) minimizing SRAM traffic subject to the tile of
    T fitting in the local buffer (paper: 'tile sizes optimized by ZigZag').

    ``local_buffer`` is a byte capacity or a per-level budget vector
    (the ``MemoryHierarchy`` residence candidates): every level
    contributes its own candidate pivots while feasibility is checked
    against the largest level — the per-level *choice* (which level's
    pJ/byte the interior pays) is ``search.tiler.tile_group``'s job.

    ``candidates_x`` defaults to the full divisor + imperfect-factor
    enumeration of ``core.tiling`` (all divisors of the pixel extent,
    powers of two, and the budget pivots); ``mode="pow2"`` restricts
    it to the power-of-two ablation baseline.  Imperfect tile sizes are
    first-class: a tile_x that does not divide the pixel extent covers it
    with a ragged last slab, charged its true (smaller) traffic but the
    full per-round weight re-stream.

    ``full_width=True`` additionally requires the whole channel extent of
    T resident per x-slab (needed when a channel-stat nonlinear sits
    between the fused layers).

    Traffic model for one IBN:
      x       : re-read in full once per c-tile round (a ragged c round
                still streams the whole input past the array)
      T       : never leaves the local buffer (that is the fusion)
      W1, W2  : re-read once per x round, ragged round included
      out     : accumulated in the RF, written once (exact volume)
    """
    n = expand.ox * expand.oy * expand.b        # pixels
    c_in = expand.c
    c_mid = expand.k                            # expanded width
    c_out = project.k
    bits = expand.bits // 8
    if candidates_x is None:
        candidates_x = tuple(budget_tile_candidates(
            n, c_mid, bits, local_buffer, mode=mode))
    if not isinstance(local_buffer, int):
        local_buffer = max(local_buffer) if local_buffer else 0

    w_bytes = (c_in * c_mid + c_mid * c_out) * bits
    x_bytes = n * c_in * bits
    out_writes = n * c_out * bits
    # the loop is the auto-scheduler's per-span hot path: plain ceil-div
    # arithmetic on the `Tiling` ragged model (rounds/ragged/traffic),
    # picking the min-traffic candidate without building records
    best_tx = best_tc = best_traffic = -1
    for tx in candidates_x:
        if tx > n:
            tx = n
        tc = min(c_mid, local_buffer // max(1, tx * bits))
        if tc < 1 or tx * tc * bits > local_buffer:
            continue        # tile of T cannot fit the local buffer
        if full_width and tc < c_mid:
            continue        # stats need the whole channel extent resident
        # x streams fully once per c round; W1/W2 stream fully once per
        # x round; the output's exact volume is written once.
        traffic = -(-c_mid // tc) * x_bytes + -(-n // tx) * w_bytes \
            + out_writes
        if best_traffic < 0 or traffic < best_traffic:
            best_tx, best_tc, best_traffic = tx, tc, traffic
    if best_traffic < 0:
        raise ValueError(
            f"no feasible IBN tile: local_buffer={local_buffer}B cannot "
            f"hold even a 1x1 tile of T ({bits}B/elem)")
    return FusedTile(tile_x=best_tx, tile_c=best_tc,
                     buffer_bytes=best_tx * best_tc * bits,
                     weight_rereads=-(-n // best_tx),
                     sram_traffic=best_traffic,
                     ragged_x=n % best_tx, ragged_c=c_mid % best_tc)
