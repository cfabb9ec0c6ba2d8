"""First-class N-level memory hierarchy (the ZigZag hardware template).

The paper's scheduling stack (temporal re-ordering, IBN fusion) exists
to minimize transfers across a *hierarchy* of memories, and ZigZag —
the engine the paper derives its schedules with — is defined over an
arbitrary ordered list of memory levels with per-level loop placement.
This module is that abstraction:

  ``MemoryLevel``      one memory: name, capacity, access energy, bus
                       width, the operand set it serves, and optional
                       hard partitions (e.g. the paper's input-mem /
                       output-RF split of the PE-coupled buffers).
  ``MemoryHierarchy``  the ordered (innermost -> outermost) level list,
                       with validation, JSON round-trip, and the
                       capacity / serve-set queries every consumer
                       (cost model, mapper, tiler, partitioner, DSE)
                       asks.

``paper_hierarchy`` builds the paper's fixed 3-level design — 8 kB
input mem + 24 kB output RF (one PE-coupled level, hard-partitioned),
512 kB SRAM with a 192 kB activation partition, and unbounded DRAM
behind a 128-bit bus — bit-exactly matching the scalar fields the seed
``HWSpec`` hard-wired.  ``costmodel.HWSpec`` carries a hierarchy and
keeps those scalars as back-compat constructor kwargs / properties.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, Optional, Tuple

# operand classes a level can serve
OPERANDS = ("input", "weight", "output")

# capacity sentinel for the unbounded backing store (bytes == 0)
UNBOUNDED = 1 << 62


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of the memory hierarchy.

    ``bytes == 0`` marks the unbounded backing store (DRAM-class);
    ``bus_bytes_per_cycle == 0`` marks an array-coupled buffer with no
    modeled bus (transfers to it ride the compute pipeline).
    ``partitions`` are hard capacity carve-outs inside the level, keyed
    by operand class or by purpose (the paper's SRAM reserves an
    ``act`` partition for activations; the rest double-buffers weights).
    """
    name: str
    bytes: int
    pj_per_byte: float
    bus_bytes_per_cycle: int = 0
    serves: Tuple[str, ...] = OPERANDS
    partitions: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        if not self.name:
            raise ValueError("memory level needs a name")
        if self.name in ("compute", "static"):
            # level names become energy-bucket keys next to these two
            # fixed buckets — a collision would silently merge (and for
            # "static": overwrite) the level's energy
            raise ValueError(f"level name {self.name!r} collides with a "
                             f"reserved energy bucket")
        if self.bytes < 0 or self.pj_per_byte < 0 \
                or self.bus_bytes_per_cycle < 0:
            raise ValueError(f"negative spec on level {self.name!r}")
        if not self.serves:
            raise ValueError(f"level {self.name!r} serves no operand")
        for s in self.serves:
            if s not in OPERANDS:
                raise ValueError(f"level {self.name!r}: unknown operand "
                                 f"{s!r} (choose from {OPERANDS})")
        keys = [k for k, _ in self.partitions]
        if len(keys) != len(set(keys)):
            raise ValueError(f"level {self.name!r}: duplicate partition")
        for k, v in self.partitions:
            if v < 0:
                raise ValueError(f"level {self.name!r}: negative "
                                 f"partition {k!r}")
        if self.bounded and sum(v for _, v in self.partitions) > self.bytes:
            raise ValueError(f"level {self.name!r}: partitions exceed "
                             f"capacity")

    @property
    def bounded(self) -> bool:
        return self.bytes > 0

    @property
    def capacity(self) -> int:
        """Usable capacity (``UNBOUNDED`` for the backing store)."""
        return self.bytes if self.bounded else UNBOUNDED

    def partition(self, key: str, default: Optional[int] = None) -> int:
        """Capacity of a named partition; ``default`` (or the whole
        level) when the partition does not exist."""
        for k, v in self.partitions:
            if k == key:
                return v
        return self.capacity if default is None else default

    def serve_capacity(self, operand: str) -> int:
        """Bytes available to ``operand`` at this level: 0 if the level
        does not serve it, its partition if one is named after it, the
        whole level otherwise."""
        if operand not in self.serves:
            return 0
        return self.partition(operand)


@dataclasses.dataclass(frozen=True)
class MemoryHierarchy:
    """Ordered memory levels, innermost (PE-coupled) -> outermost
    (backing store).  The level *names* are the single source of truth
    for every per-level cost row and energy bucket downstream —
    ``costmodel.energy_buckets`` derives from them, so adding a level
    can never silently drop energy."""
    levels: Tuple[MemoryLevel, ...]

    def __post_init__(self):
        object.__setattr__(self, "levels", tuple(self.levels))
        if len(self.levels) < 3:
            # the cost model's roles are positional: PE-coupled buffers
            # (innermost), >= 1 on-chip stream/spill level, backing
            # store — with only 2 levels operand streaming would be
            # charged to DRAM and depth-first fusion silently disabled
            raise ValueError("a hierarchy needs >= 3 levels (PE-coupled "
                             "buffers, an on-chip stream level, and the "
                             "backing store)")
        names = [l.name for l in self.levels]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate level names: {names}")
        for l in self.levels[:-1]:
            if not l.bounded:
                raise ValueError(f"only the outermost level may be "
                                 f"unbounded, not {l.name!r}")
        for inner, outer in zip(self.levels, self.levels[1:]):
            if outer.bounded and outer.bytes < inner.bytes:
                raise ValueError(
                    f"capacities must not shrink outward: "
                    f"{outer.name!r} ({outer.bytes}B) < "
                    f"{inner.name!r} ({inner.bytes}B)")
        out = self.levels[-1]
        if set(out.serves) != set(OPERANDS):
            raise ValueError("the backing store must serve every operand")

    # -- queries ------------------------------------------------------

    @property
    def names(self) -> Tuple[str, ...]:
        try:
            return object.__getattribute__(self, "_names")
        except AttributeError:
            names = tuple(l.name for l in self.levels)
            object.__setattr__(self, "_names", names)
            return names

    def index(self, name: str) -> int:
        for i, l in enumerate(self.levels):
            if l.name == name:
                return i
        raise KeyError(f"no memory level {name!r}; have {self.names}")

    def level(self, name: str) -> MemoryLevel:
        return self.levels[self.index(name)]

    @property
    def innermost(self) -> MemoryLevel:
        return self.levels[0]

    @property
    def outermost(self) -> MemoryLevel:
        return self.levels[-1]

    @property
    def on_chip(self) -> Tuple[MemoryLevel, ...]:
        return self.levels[:-1]

    @property
    def spill_level(self) -> MemoryLevel:
        """The outermost on-chip level — inter-group activations that
        exceed its ``act`` partition round-trip the backing store."""
        return self.levels[-2]

    @property
    def act_budget_bytes(self) -> int:
        return self.spill_level.partition("act")

    def local_levels(self) -> Tuple[MemoryLevel, ...]:
        """Candidate residence levels for depth-first fusion-group
        intermediates: every level strictly inside the spill level."""
        return self.levels[:-2]

    def stationary_level(self, operand: str, tile_bytes: int
                         ) -> MemoryLevel:
        """Innermost level that serves ``operand`` and can hold its
        resident tile (the outermost level always qualifies)."""
        for l in self.levels:
            if l.serve_capacity(operand) >= tile_bytes:
                return l
        return self.outermost

    def fill_level(self, operand: str, tile_bytes: int) -> MemoryLevel:
        """The level whose port the per-round fill/drain traffic of
        ``operand`` crosses: the refill source when the tile sits in the
        innermost (array-coupled) buffers, the stationary level itself
        when the operand streams past the array from deeper in the
        hierarchy."""
        st = self.stationary_level(operand, tile_bytes)
        return self.fill_for_placement(operand, st.name)

    def fill_for_placement(self, operand: str,
                           level_name: str) -> MemoryLevel:
        """``fill_level`` in its placement-name form — the single owner
        of the rule shared by the mapper's candidate ranking and the
        placement-aware headline costing: a tile stationed in the
        innermost (array-coupled) buffers refills from the first outer
        level serving the operand; one stationed deeper streams through
        its own level's port."""
        if level_name != self.innermost.name:
            return self.level(level_name)
        for l in self.levels[1:]:
            if operand in l.serves:
                return l
        return self.outermost

    # -- signatures ---------------------------------------------------

    @property
    def cap_signature(self) -> str:
        """Capacity-structure signature: a content hash of everything
        operand placement reads — level order, capacities, serve sets,
        and partitions — with access energies excluded.  Two hierarchies
        with equal cap signatures place every tile identically; only the
        pJ/byte used to *rank* candidates may differ, so a memoized
        mapspace table keyed by this signature is re-costed, never
        re-enumerated, when a DSE sweep reprices a level (see
        ``search.memo``).  Computed once per (frozen) instance and
        returned as a short string (whose hash CPython caches) — memo
        keys hash it on every lookup."""
        try:
            return object.__getattribute__(self, "_cap_sig")
        except AttributeError:
            blob = repr(tuple((l.name, l.bytes, l.serves, l.partitions,
                               l.bus_bytes_per_cycle)
                              for l in self.levels))
            sig = hashlib.sha256(blob.encode()).hexdigest()[:16]
            object.__setattr__(self, "_cap_sig", sig)
            return sig

    @property
    def signature(self) -> str:
        """Full content signature (capacity structure + access
        energies): hierarchies with equal signatures are interchangeable
        to every mapper/tiler/partitioner decision."""
        try:
            return object.__getattribute__(self, "_sig")
        except AttributeError:
            blob = repr(tuple((l.name, l.bytes, l.pj_per_byte,
                               l.bus_bytes_per_cycle, l.serves,
                               l.partitions) for l in self.levels))
            sig = hashlib.sha256(blob.encode()).hexdigest()[:16]
            object.__setattr__(self, "_sig", sig)
            return sig

    # -- derivation ---------------------------------------------------

    def replace_level(self, name: str, **changes) -> "MemoryHierarchy":
        i = self.index(name)
        lv = dataclasses.replace(self.levels[i], **changes)
        return MemoryHierarchy(self.levels[:i] + (lv,)
                               + self.levels[i + 1:])

    def with_partition(self, name: str, key: str, nbytes: int, *,
                       resize: bool = False) -> "MemoryHierarchy":
        """Set one partition.  ``resize=True`` grows/shrinks the level
        so the partition sum stays intact (the paper's PE-coupled level
        is fully partitioned: resizing the output RF resizes the
        level)."""
        lvl = self.level(name)
        parts = dict(lvl.partitions)
        old = parts.get(key, 0)
        parts[key] = nbytes
        total = lvl.bytes + (nbytes - old if resize else 0)
        if not lvl.bounded:
            total = 0
        return self.replace_level(name, bytes=total,
                                  partitions=tuple(parts.items()))

    def resized(self, name: str, *, bytes: Optional[int] = None,
                pj_per_byte: Optional[float] = None) -> "MemoryHierarchy":
        """Resize / reprice one level; partitions scale proportionally
        with a capacity change (the act share of the SRAM stays 3/8)."""
        lvl = self.level(name)
        changes: Dict[str, object] = {}
        if bytes is not None and lvl.bounded and bytes != lvl.bytes:
            scale = bytes / lvl.bytes
            changes["bytes"] = bytes
            changes["partitions"] = tuple(
                (k, int(v * scale)) for k, v in lvl.partitions)
        if pj_per_byte is not None:
            changes["pj_per_byte"] = pj_per_byte
        if not changes:
            return self
        return self.replace_level(name, **changes)

    # -- JSON round-trip ---------------------------------------------

    def to_json(self) -> dict:
        return {"levels": [{
            "name": l.name, "bytes": l.bytes,
            "pj_per_byte": l.pj_per_byte,
            "bus_bytes_per_cycle": l.bus_bytes_per_cycle,
            "serves": list(l.serves),
            "partitions": {k: v for k, v in l.partitions},
        } for l in self.levels]}

    @classmethod
    def from_json(cls, raw) -> "MemoryHierarchy":
        if isinstance(raw, str):
            raw = json.loads(raw)
        return cls(tuple(MemoryLevel(
            name=d["name"], bytes=int(d["bytes"]),
            pj_per_byte=float(d["pj_per_byte"]),
            bus_bytes_per_cycle=int(d.get("bus_bytes_per_cycle", 0)),
            serves=tuple(d.get("serves", OPERANDS)),
            partitions=tuple(sorted(
                (k, int(v)) for k, v in d.get("partitions", {}).items())),
        ) for d in raw["levels"]))


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def paper_hierarchy(*, input_mem_bytes: int = 8 * 1024,
                    output_rf_bytes: int = 24 * 1024,
                    sram_bytes: int = 512 * 1024,
                    act_budget_bytes: int = 192 * 1024,
                    dram_bus_bytes_per_cycle: int = 16,
                    e_rf_byte: float = 0.15,
                    e_sram_byte: float = 1.2,
                    e_dram_byte: float = 100.0) -> MemoryHierarchy:
    """The paper's fixed 3-level design (defaults = the seed ``HWSpec``
    scalars, bit-exactly): a PE-coupled RF level hard-partitioned into
    the 8 kB input mem and 24 kB output RF, the 512 kB SRAM with its
    192 kB activation partition, and unbounded DRAM on a 128-bit bus."""
    return MemoryHierarchy((
        MemoryLevel("rf", input_mem_bytes + output_rf_bytes, e_rf_byte,
                    serves=("input", "output"),
                    partitions=(("input", input_mem_bytes),
                                ("output", output_rf_bytes))),
        MemoryLevel("sram", sram_bytes, e_sram_byte,
                    bus_bytes_per_cycle=dram_bus_bytes_per_cycle,
                    partitions=(("act", act_budget_bytes),)),
        MemoryLevel("dram", 0, e_dram_byte,
                    bus_bytes_per_cycle=dram_bus_bytes_per_cycle),
    ))


def split_sram_hierarchy(base: Optional[MemoryHierarchy] = None, *,
                         l1_bytes: int = 64 * 1024,
                         l1_pj_per_byte: float = 0.6) -> MemoryHierarchy:
    """A 4-level variant of the paper design for hierarchy-DSE studies:
    the SRAM splits into a small fast L1 in front of the (renamed) L2.
    The L2 keeps the act partition (it still gates inter-group spills);
    the L1 serves as an extra residence level for depth-first fusion
    intermediates too large for the RF."""
    base = base or paper_hierarchy()
    sram = base.spill_level
    l1 = MemoryLevel("l1", l1_bytes, l1_pj_per_byte)
    l2 = dataclasses.replace(sram, name="l2")
    return MemoryHierarchy(
        base.levels[:-2] + (l1, l2) + (base.outermost,))


# ---------------------------------------------------------------------------
# CLI override parsing  (`--mem name:bytes[:pj]`)
# ---------------------------------------------------------------------------

_SUFFIX = {"kb": 1024, "mb": 1024 * 1024, "k": 1024, "m": 1024 * 1024,
           "b": 1}


def parse_size(text: str) -> int:
    t = text.strip().lower()
    for suf, mul in _SUFFIX.items():
        if t.endswith(suf):
            return int(float(t[:-len(suf)]) * mul)
    return int(t)


def parse_mem(spec: str) -> Tuple[str, int, Optional[float]]:
    """Parse a ``name:bytes[:pj]`` CLI override, e.g. ``sram:256kb`` or
    ``dram:0:80`` (repricing the backing store)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"--mem wants name:bytes[:pj], got {spec!r}")
    name, nbytes = parts[0].strip(), parse_size(parts[1])
    pj = float(parts[2]) if len(parts) == 3 else None
    if not name:
        raise ValueError(f"--mem wants a level name: {spec!r}")
    return name, nbytes, pj


def apply_mem_overrides(h: MemoryHierarchy,
                        specs: Iterable[str]) -> MemoryHierarchy:
    """Apply ``--mem`` overrides; every impossible request is an error,
    never a silent no-op (unknown level names list the valid ones, the
    unbounded backing store only accepts the ``name:0:pj`` repricing
    form, bounded levels need a positive size)."""
    for spec in specs:
        name, nbytes, pj = parse_mem(spec)
        if name not in h.names:
            raise KeyError(f"--mem {spec!r}: no level {name!r} "
                           f"(hierarchy levels: {', '.join(h.names)})")
        lvl = h.level(name)
        if not lvl.bounded and nbytes > 0:
            raise ValueError(f"--mem {spec!r}: cannot resize the "
                             f"unbounded backing store; use "
                             f"{name}:0:<pj> to reprice it")
        if lvl.bounded and nbytes == 0:
            raise ValueError(f"--mem {spec!r}: level size must be > 0")
        if nbytes == 0 and pj is None:
            raise ValueError(f"--mem {spec!r}: nothing to change "
                             f"(give a size or a pJ/byte)")
        h = h.resized(name, bytes=nbytes or None, pj_per_byte=pj)
    return h
