"""Markdown "schedule explain" report — why the scheduler chose what it
chose, in the paper's own breakdown vocabulary.

``explain_schedule`` renders one searched ``Schedule`` as markdown:

  * header: workload, content key, search version, array shape, memory
    hierarchy, headline cost numbers (latency / energy / EDP / fps) and
    the mean spatial utilization the factored mapspace exists to raise;
  * the per-level traffic/energy breakdown (the paper-style
    energy-breakdown table: bytes moved through each memory level's
    port, the pJ they cost, and each level's share of total energy);
  * a per-layer table: the chosen spatial mapping (``mapping_label``
    form, e.g. ``4xOX*4xK|16xC``), temporal loop order, per-operand
    stationarity placements, compute cycles, and per-level traffic;
  * the fusion partition: per group its members, the depth-first tile
    (tile_x/tile_c, residence level, ragged edges), and the DRAM spill
    edges between groups.

The report reads only the schedule + a re-evaluation under the shared
cost accounting — it never re-runs the search — so ``--explain`` on a
cache replay is as cheap as the replay.  Imports of the search/core
stack are deferred into the function so ``repro_torch.obs`` stays importable
from anywhere in the stack without cycles.
"""
from __future__ import annotations

from typing import List, Sequence


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1 << 30), ("MB", 1 << 20), ("kB", 1 << 10)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


def _table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    lines = ["| " + " | ".join(header) + " |",
             "|" + "|".join("---" for _ in header) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(r) + " |")
    return "\n".join(lines)


def explain_schedule(layers, schedule, hw=None) -> str:
    """Render one searched Schedule as a markdown explain report (see
    the module docstring for the sections).  ``hw`` defaults to the
    HWSpec embedded in the schedule artifact, so a replayed schedule
    explains itself without the caller reconstructing the spec."""
    import dataclasses

    from repro_torch.core.costmodel import HWSpec
    from repro_torch.core.dataflow import mapping_label
    from repro_torch.core.memory import MemoryHierarchy
    from repro_torch.core.schedule import level_breakdown
    from repro_torch.search.auto import evaluate_schedule

    if hw is None:
        doc = dict(schedule.hw)
        hier = MemoryHierarchy.from_json(doc.pop("hierarchy"))
        hw = dataclasses.replace(HWSpec(), hierarchy=hier, **{
            k: v for k, v in doc.items()
            if k in {f.name for f in dataclasses.fields(HWSpec)}})

    nc = evaluate_schedule(layers, schedule, hw)
    by_level = level_breakdown(nc)
    buckets = nc.energy_pj()           # per-bucket: compute/levels/static
    total_pj = sum(buckets.values())
    cost = schedule.cost

    out: List[str] = []
    out.append(f"## Schedule explain: {schedule.workload}")
    out.append("")
    out.append(f"- key `{schedule.key}` (search v{schedule.version}), "
               f"tile_mode={schedule.tile_mode}, "
               f"spatial_mode={schedule.spatial_mode}"
               + (", fixed wiring" if schedule.fixed_wiring else ""))
    out.append(f"- array {hw.rows}x{hw.cols} PEs @ "
               f"{hw.clock_hz / 1e6:.0f} MHz, hierarchy "
               + " / ".join(
                   f"{l.name}" + (f" {_fmt_bytes(l.bytes)}"
                                  if l.bounded else "")
                   for l in hw.hierarchy.levels))
    if cost:
        out.append(f"- latency {cost['latency_s'] * 1e3:.3g} ms, energy "
                   f"{cost['energy_j'] * 1e3:.3g} mJ, EDP "
                   f"{cost['edp']:.4g}, {cost['fps']:.1f} fps")
        out.append(f"- mean spatial utilization "
                   f"{cost['spatial_util']:.3f} over MAC layers")
    out.append("")

    # -- per-level energy breakdown (the paper-style table) ------------
    out.append("### Per-level traffic / energy breakdown")
    out.append("")
    rows = []
    for name, d in by_level.items():
        share = d["energy_pj"] / total_pj if total_pj else 0.0
        rows.append((name, _fmt_bytes(d["bytes"]),
                     f"{d['energy_pj'] / 1e6:.4g}",
                     f"{share * 100:.1f}%"))
    for name in ("compute", "static"):
        pj = buckets.get(name, 0.0)
        share = pj / total_pj if total_pj else 0.0
        rows.append((name, "-", f"{pj / 1e6:.4g}",
                     f"{share * 100:.1f}%"))
    rows.append(("**total**", _fmt_bytes(sum(
        d["bytes"] for d in by_level.values())),
        f"{total_pj / 1e6:.4g}", "100.0%"))
    out.append(_table(("level", "traffic", "energy (uJ)", "share"), rows))
    out.append("")

    # -- per-layer decisions ------------------------------------------
    level_names = [l.name for l in hw.hierarchy.levels]
    lc_by_name = {lc.layer.name: lc for lc in nc.layers}
    out.append("### Per-layer mapping decisions")
    out.append("")
    rows = []
    for name, mapping in schedule.mappings.items():
        lc = lc_by_name.get(name)
        order = "".join(schedule.orders.get(name, ())) or "-"
        pl = schedule.placements.get(name, {})
        place = " ".join(f"{op[0]}:{lvl}" for op, lvl in
                         sorted(pl.items())) or "-"
        traffic = " ".join(
            f"{ln}:{_fmt_bytes(lc.traffic[ln])}"
            for ln in level_names if lc and lc.traffic.get(ln)) \
            if lc else "-"
        label = mapping_label(mapping).replace("|", "\\|")
        rows.append((name, lc.layer.op if lc else "?",
                     f"`{label}`", order,
                     f"{lc.compute_cycles}" if lc else "-",
                     place, traffic))
    out.append(_table(("layer", "op", "mapping", "order", "cycles",
                       "placement", "traffic"), rows))
    out.append("")

    # -- fusion groups + tiles ----------------------------------------
    out.append("### Fusion groups")
    out.append("")
    rows = []
    for gi, g in enumerate(schedule.groups):
        head = g[0]
        tile = next((schedule.tiles[n] for n in g
                     if n in schedule.tiles), None)
        if tile:
            tdesc = (f"{tile['tile_x']}x{tile['tile_c']} @ "
                     f"{tile.get('level', 'rf')}")
            if tile.get("ragged_x") or tile.get("ragged_c"):
                tdesc += (f" (ragged {tile.get('ragged_x', 0)}/"
                          f"{tile.get('ragged_c', 0)})")
        else:
            tdesc = "-"
        rows.append((str(gi), f"{len(g)}",
                     head + ("…" if len(g) > 1 else ""), tdesc))
    out.append(_table(("group", "layers", "head", "tile (x*c @ level)"),
                      rows))
    if schedule.edges:
        out.append("")
        out.append("DRAM spill edges (producer -> consumer, bytes):")
        for p, c, b in schedule.edges:
            out.append(f"- layer {p} -> layer {c}: {_fmt_bytes(b)}")
    out.append("")
    return "\n".join(out)
