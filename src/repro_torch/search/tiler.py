"""Budget-driven tile search for depth-first fusion groups.

Replaces the fixed 9-candidate ``candidates_x`` list of
``core.fusion.optimize_tile`` with the full divisor + imperfect-factor
enumeration of ``core.tiling`` (all divisors of the pixel extent, the
powers of two, and the budget pivots — imperfect factors cover the
extent with a ragged last tile charged its true cost), and generalizes
from the IBN pw-pair to arbitrary chains of pixel-aligned MAC layers
(pointwise / matmul) with interleaved elementwise or channel-stat
nonlinears.

Tiling model (the paper's Fig 4 depth-first schedule):
  * the group input streams from SRAM; every intermediate tensor lives
    only in the local buffer, tiled along (X = pixels, C = channels);
  * a 2-layer group may tile the single intermediate along C and
    contract each (tile_x, tile_c) slab into the output accumulator
    immediately (re-reading the input once per C round);
  * deeper chains keep full-width x-slabs resident; the peak footprint
    is the widest adjacent pair of intermediates (channel tiling would
    force partial re-computation);
  * an interior channel-stat nonlinear (norm/softmax) needs its whole
    reduction vector resident -> full channel width at that edge;
  * a ragged last slab (imperfect tile_x) moves its true, smaller data
    volume but still pays the full per-round weight re-stream.

Infeasible tilings (tile cannot fit the buffer) are *skipped*, never
returned — a group with no feasible tile is simply not fusible.

With an N-level ``MemoryHierarchy`` the group's intermediates may live
at any level strictly inside the spill level (``budgets`` — a per-level
budget vector instead of the single local buffer): a deeper level fits
larger slabs (fewer weight re-streams from the act SRAM) but charges
its own pJ/byte on every intermediate byte.  ``tile_group`` searches
tile sizes *per candidate level* and returns the energy-minimizing
(level, tile) pair; with the default 3-level hierarchy the only
candidate is the RF, reproducing the seed behavior exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core import fusion
from repro_torch.core.fusion import FusedTile
from repro_torch.core.tiling import budget_tile_candidates
from repro_torch.core.workload import MAC_OPS, NORM, SOFTMAX, Layer

# one budget entry: (level name, capacity bytes, pJ/byte)
LevelBudget = Tuple[str, int, float]


def _candidates_x(n: int, widest: int, bytes_per: int,
                  local_buffer, mode: str = "full") -> List[int]:
    """Tile_x candidates: all divisors of ``n`` plus powers of two plus
    the budget pivots of every level in the budget vector — the largest
    x-tile that keeps the widest intermediate fully resident, and the
    largest that fits a single channel.  ``mode="pow2"`` is the
    power-of-two ablation baseline."""
    return budget_tile_candidates(n, widest, bytes_per, local_buffer,
                                  mode=mode)


@dataclasses.dataclass(frozen=True)
class GroupTile:
    """Depth-first tiling of a fused group."""
    tile_x: int                  # pixels per slab
    tile_c: int                  # channels per slab of the widest edge
    buffer_bytes: int            # peak live intermediate footprint
    weight_rereads: int          # full weight re-streams (x rounds,
    #                              ragged round included)
    sram_traffic: int            # total SRAM bytes for the group
    ragged_x: int = 0            # ragged last x slab (0 = perfect)
    ragged_c: int = 0            # ragged last c slab (0 = perfect)
    level: str = "rf"            # residence level of the intermediates


def optimize_tile(expand: Layer, project: Layer, *, local_buffer: int,
                  full_width: bool = False,
                  mode: str = "full") -> Optional[FusedTile]:
    """ZigZag-style (tile_x, tile_c) search for a fused MAC pair with the
    candidate list derived from ``local_buffer`` instead of hardcoded.

    One traffic model only: this delegates to ``core.fusion``'s
    optimizer, supplying divisor + imperfect-factor candidates (or the
    pow2-only ablation list for ``mode="pow2"``).  Returns None when no
    tile fits (the pair is not fusible at this budget).
    ``full_width=True`` forces the intermediate to keep its whole
    channel extent resident (required when a channel-stat nonlinear sits
    between the two layers).
    """
    n = expand.ox * expand.oy * expand.b
    c_mid = expand.k
    bytes_per = max(1, expand.bits // 8)
    cands = tuple(_candidates_x(n, c_mid, bytes_per, local_buffer,
                                mode=mode))
    try:
        return fusion.optimize_tile(expand, project,
                                    local_buffer=local_buffer,
                                    candidates_x=cands,
                                    full_width=full_width)
    except ValueError:
        return None


def chain_compatible(a: Layer, b: Layer) -> bool:
    """Can MAC layer ``b`` consume ``a``'s output depth-first?  Requires
    pixel alignment (1x1 channel mixing on the same pixel grid)."""
    if a.op not in ("pwconv", "matmul") or b.op not in ("pwconv", "matmul"):
        return False
    pa = a.b * a.ox * a.oy
    pb = b.b * b.ox * b.oy
    return pa == pb and a.k == b.c


def interior_bytes(group: Sequence[Layer]) -> int:
    """Bytes of the inter-MAC intermediate tensors — the data that lives
    only at the group's residence level (each byte is written once and
    read once there)."""
    macs = [l for l in group if l.op in MAC_OPS]
    return sum(l.output_bytes for l in macs[:-1])


def _tile_group_at(group: Sequence[Layer], capacity: int,
                   mode: str) -> Optional[GroupTile]:
    """Best tiling of a multi-MAC slice at one residence capacity."""
    macs = [l for l in group if l.op in MAC_OPS]
    # does a channel-stat nonlinear sit between two MAC layers?
    stats_interior = False
    seen_mac = 0
    for l in group:
        if l.op in MAC_OPS:
            seen_mac += 1
        elif l.op in (NORM, SOFTMAX) and 0 < seen_mac < len(macs):
            stats_interior = True

    if len(macs) == 2:
        ft = optimize_tile(macs[0], macs[1], local_buffer=capacity,
                           full_width=stats_interior, mode=mode)
        if ft is None:
            return None
        return GroupTile(tile_x=ft.tile_x, tile_c=ft.tile_c,
                         buffer_bytes=ft.buffer_bytes,
                         weight_rereads=ft.weight_rereads,
                         sram_traffic=ft.sram_traffic,
                         ragged_x=ft.ragged_x, ragged_c=ft.ragged_c)

    # deeper chain: full-width x-slabs; an intermediate is live from its
    # production until its consumer's slab is complete, so the peak
    # footprint is the widest *adjacent pair* of intermediates (earlier
    # ones are discarded as the slab walks down the chain)
    n = macs[0].b * macs[0].ox * macs[0].oy
    bytes_per = max(1, macs[0].bits // 8)
    widths = [l.k for l in macs[:-1]]
    peak_width = max(a + b for a, b in zip(widths, widths[1:])) \
        if len(widths) > 1 else widths[0]
    w_bytes = sum(l.weight_bytes for l in macs)
    io_bytes = macs[0].input_bytes + macs[-1].output_bytes
    best_tx = best_traffic = -1
    for tx in _candidates_x(n, peak_width, bytes_per, capacity,
                            mode=mode):
        buf = tx * peak_width * bytes_per
        if buf > capacity:
            continue
        # weights re-stream in full each x round (ragged round included
        # — the `Tiling` ragged model as plain ceil-div arithmetic);
        # input / output move their exact volume once.
        traffic = -(-n // tx) * w_bytes + io_bytes
        if best_traffic < 0 or traffic < best_traffic:
            best_tx, best_traffic = tx, traffic
    if best_traffic < 0:
        return None
    return GroupTile(tile_x=best_tx, tile_c=max(widths),
                     buffer_bytes=best_tx * peak_width * bytes_per,
                     weight_rereads=-(-n // best_tx),
                     sram_traffic=best_traffic,
                     ragged_x=n % best_tx)


def tile_group(group: Sequence[Layer], *,
               local_buffer: Optional[int] = None,
               mode: str = "full",
               budgets: Optional[Sequence[LevelBudget]] = None,
               stream_pj: float = 0.0) -> Optional[GroupTile]:
    """Feasibility + tiling for a fusion-group layer slice.

    The slice holds >= 1 MAC layer plus interleaved nonlinears.  A single
    MAC layer has no interior tensor (trivially feasible).  Multi-MAC
    slices run depth-first; returns None when the chain is incompatible
    or no tile fits any budget.

    ``budgets`` is the per-level budget vector — candidate residence
    levels for the interior tensors as (name, capacity, pJ/byte),
    innermost first.  Per level the tile search minimizes SRAM traffic;
    across levels the choice minimizes energy: group streaming at
    ``stream_pj`` plus the interior write+read at the residence level's
    pJ/byte.  ``local_buffer`` is the single-level shorthand
    (equivalent to ``budgets=[("rf", local_buffer, 0.0)]``).

    This is the pure (memo-free) form; the partitioner's DP, which
    re-probes the same block signatures O(n * max_span) times, inlines
    the same per-budget search against the ``group_tile`` memo table
    (``partition_chain``) — the per-level tile depends only on (shapes,
    capacity, mode), never on access energies, so one entry serves every
    DP probe of a repeated block and every DSE variant sharing the
    residence capacity, while the cross-level energy choice is re-costed
    live (the incremental-DSE split).
    """
    if budgets is None:
        if local_buffer is None:
            raise TypeError("tile_group needs local_buffer or budgets")
        budgets = (("rf", local_buffer, 0.0),)
    macs = [l for l in group if l.op in MAC_OPS]
    if not macs:
        return None
    if len(macs) == 1:
        return GroupTile(tile_x=0, tile_c=0, buffer_bytes=0,
                         weight_rereads=1, sram_traffic=0,
                         level=budgets[0][0] if budgets else "rf")
    for a, b in zip(macs, macs[1:]):
        if not chain_compatible(a, b):
            return None

    interior = interior_bytes(group)
    best: Optional[GroupTile] = None
    best_pj = 0.0
    for name, capacity, level_pj in budgets:
        t = _tile_group_at(group, capacity, mode)
        if t is None:
            # no candidate fits this budget level (provenance counter,
            # no-op untraced; the partitioner's memoized probe loop
            # counts its own rejections the same way)
            obs.count(f"tiler.reject.{name}")
            continue
        pj = t.sram_traffic * stream_pj + 2 * interior * level_pj
        if best is None or pj < best_pj:
            best = t if t.level == name else \
                dataclasses.replace(t, level=name)
            best_pj = pj
    return best
