"""Imperfect-factor tiling: shared enumeration + ragged-edge accounting.

ZigZag proper searches *all* divisors of a loop extent plus "imperfect"
factors — tile sizes ``t`` that do not divide the extent ``n``, covering
it with ``ceil(n/t)`` tiles of which the last is *ragged* (size
``n mod t``).  The seed search stack only enumerated powers of two plus
two budget pivots, which silently over- or under-tiles exactly the
layers the paper optimizes: EdgeNeXt-S channel/pixel extents
(48/96/160/304, 3-scale SDTA splits) are not powers of two.

This module is the single source of truth for both halves of the fix:

  * ``tile_candidates`` / ``budget_tile_candidates`` — the candidate
    tile sizes every searcher (``core.fusion.optimize_tile``,
    ``search.tiler``, ``search.mapper``) enumerates;
  * ``Tiling`` — the (extent, tile) record that makes ragged-edge cost
    explicit: a ragged last tile moves its true (smaller) data volume
    but pays the same per-round overhead (weight re-stream, input
    re-read) as a full tile.

Cost rule of thumb encoded here: per-element traffic is exact
(``Tiling.extent`` elements total, never ``rounds * tile``), per-round
overhead is charged ``Tiling.rounds`` times — including once for the
ragged round.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

# Candidate-enumeration modes:
#   "full"   — all divisors + powers of two + caller-supplied imperfect
#              (budget-derived) factors: the ZigZag-style space.
#   "legacy" — powers of two + the extent itself + the caller-supplied
#              pivots: the exact PR-1 seed space, kept so the divisor
#              enumeration is also measured against the actual prior
#              stack (not only the weaker pow2 ablation).
#   "pow2"   — powers of two <= n only: the literal pow2-only ablation.
MODES = ("full", "legacy", "pow2")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def divisors(n: int) -> List[int]:
    """All positive divisors of ``n``, ascending."""
    if n < 1:
        return []
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return small + large[::-1]


def pow2s_upto(n: int) -> List[int]:
    """Powers of two <= n (n itself is NOT appended unless a power of
    two — this is the literal pow2-only space)."""
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def tile_candidates(n: int, extra: Iterable[int] = (),
                    mode: str = "full") -> List[int]:
    """Candidate tile sizes for a loop of extent ``n``, ascending.

    ``extra`` carries budget-derived pivots (e.g. the largest tile whose
    working set fits a buffer); they are clamped to [1, n] and kept even
    when imperfect.  Powers of two are retained in "full" mode so the
    enumeration is a strict superset of the legacy space (the search can
    only improve).
    """
    if mode not in MODES:
        raise ValueError(f"unknown tile-candidate mode {mode!r}")
    if n < 1:
        return []
    if mode == "pow2":
        return pow2s_upto(n)
    cands = set(pow2s_upto(n))
    cands.add(n)
    if mode == "full":
        cands.update(divisors(n))
    for e in extra:
        if e >= 1:
            cands.add(min(int(e), n))
    return sorted(cands)


def budget_tile_candidates(n: int, widest: int, bytes_per: int,
                           budget, mode: str = "full") -> List[int]:
    """``tile_candidates`` with the budget pivots used across the search
    stack: per budget, the largest tile keeping ``widest`` elements per
    point fully resident, and the largest single-row tile.  Either pivot
    may be an imperfect factor of ``n`` — that is the point.

    ``budget`` is a byte capacity or a per-level budget vector (one
    capacity per candidate memory level — every level contributes its
    own pair of pivots, so an N-level hierarchy widens the candidate
    set instead of collapsing to one buffer's view).
    """
    budgets: Sequence[int] = (budget,) if isinstance(budget, int) \
        else tuple(budget)
    extra: List[int] = []
    for b in budgets:
        extra.append(b // max(1, widest * bytes_per))
        extra.append(b // max(1, bytes_per))
    return tile_candidates(n, extra=extra, mode=mode)


@dataclasses.dataclass(frozen=True)
class Tiling:
    """One loop extent covered by ``rounds`` tiles of size ``tile``, the
    last of which may be ragged (smaller).  ``tile`` need not divide
    ``extent`` — imperfect factors are first-class."""
    extent: int
    tile: int

    def __post_init__(self):
        if self.extent < 1 or self.tile < 1:
            raise ValueError(f"invalid tiling {self.extent}/{self.tile}")
        if self.tile > self.extent:
            object.__setattr__(self, "tile", self.extent)

    @property
    def rounds(self) -> int:
        """Total tile count, ragged tile included."""
        return ceil_div(self.extent, self.tile)

    @property
    def ragged(self) -> int:
        """Size of the ragged last tile (0 when ``tile | extent``)."""
        return self.extent % self.tile

    @property
    def perfect(self) -> bool:
        return self.ragged == 0

    def round_sizes(self) -> List[int]:
        """Per-round tile sizes; sums exactly to ``extent`` (coverage)."""
        full = self.extent // self.tile
        out = [self.tile] * full
        if self.ragged:
            out.append(self.ragged)
        return out

    def traffic(self, per_elem: int, per_round: int = 0) -> int:
        """Ragged-aware cost: every element moves once per covering pass
        (the ragged tile is charged its true, smaller volume) while each
        round — ragged included — pays the full per-round overhead."""
        return self.extent * per_elem + self.rounds * per_round
