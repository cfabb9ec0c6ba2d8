"""Unique-layer memoization for the auto-scheduler.

Hybrid ViT graphs repeat identical layer shapes across stages
(MobileViT-S registers 156 layers but far fewer unique ones; EdgeNeXt-S
stages reuse the 48/96/160/304 dims), and a DSE sweep re-solves every
layer once per hardware variant.  ``SearchMemo`` keys every search
sub-result by *content* — the canonical ``Layer.signature`` (shape/op
hash, independent of layer name and position) plus the slice of the
hardware the sub-result actually reads — so each unique subproblem is
solved once and fanned back out:

  spatial     best spatial mapping per (layer_sig, rows, cols, wiring,
              spatial_mode) — pair or factored per-axis assignments —
              independent of the memory hierarchy, so a memory-sizing
              sweep reuses every entry across all its variants.
  table       the temporal-mapspace candidate table per (layer_sig,
              innermost buffer capacities, tile_mode) — the tile sizes,
              ragged trip counts, and per-operand tile footprints; all
              pJ-independent, so resizing an outer level only re-costs.
  placement   operand-stationarity resolution per (capacity signature,
              operand, tile bytes) — where a tile resides and which
              level's port its fill/drain traffic crosses.
  resolved    the tile table with placements resolved per (layer_sig,
              capacity signature, tile_mode) — everything the loop-order
              selection reads except the pJ/byte it ranks by, so a
              repriced variant re-costs with plain arithmetic.
  temporal    the selected loop order per (layer_sig, full hierarchy
              signature, pixelwise constraint, tile_mode).
  group_tile  depth-first group tilings per (member signature tuple,
              residence capacity, tile_mode) — shared by every DP probe
              of a repeated block and by every DSE variant with the
              same residence budget.

Memoization is exact: every key covers the entire input set of the
cached computation, and ``auto_schedule(dedup=False)`` re-derives
everything brute-force so equality is testable bit-for-bit
(``tests/test_search_perf.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional

from repro_torch.search.perf import PerfRecorder

TABLES = ("spatial", "table", "placement", "resolved", "temporal",
          "group_tile")


class SearchMemo:
    """Content-addressed memo tables shared across layers of one search
    and across the variants of one DSE sweep."""

    def __init__(self, perf: Optional[PerfRecorder] = None) -> None:
        self.perf = perf if perf is not None else PerfRecorder()
        self._tables: Dict[str, Dict[Hashable, object]] = \
            {t: {} for t in TABLES}

    def lookup(self, table: str, key: Hashable,
               compute: Callable[[], object]) -> object:
        """Return the cached value for ``key`` in ``table``, computing
        (and counting the miss) on first sight."""
        tab = self._tables[table]
        try:
            val = tab[key]
        except KeyError:
            self.perf.count(f"memo.{table}.miss")
            val = tab[key] = compute()
            return val
        self.perf.count(f"memo.{table}.hit")
        return val

    def raw(self, table: str) -> Dict[Hashable, object]:
        """The backing dict of one table, for hot paths that inline
        their own get/set (and bulk-report hits/misses through
        ``perf.count`` so the hit-rate accounting stays whole)."""
        return self._tables[table]

    def size(self, table: Optional[str] = None) -> int:
        if table is not None:
            return len(self._tables[table])
        return sum(len(t) for t in self._tables.values())
