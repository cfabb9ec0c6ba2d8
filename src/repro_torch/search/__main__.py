"""CLI: run the auto-scheduler / DSE and write JSON schedule artifacts.

    PYTHONPATH=src python -m repro_torch.search --workload edgenext-s \
        --out schedule.json
    PYTHONPATH=src python -m repro_torch.search --workload vit-tiny --dse
    PYTHONPATH=src python -m repro_torch.search --workload edgenext-s \
        --mem sram:1mb --mem rf:16kb            # resize hierarchy levels
    PYTHONPATH=src python -m repro_torch.search --workload edgenext-s \
        --dse-mem rf sram                        # L1-vs-L2 sizing sweep
    PYTHONPATH=src python -m repro_torch.search --workload edgenext-s \
        --profile                                # perf.* fast-path rows

Exit code 0 on success; the schedule artifact is reusable through
``repro_torch.search.cache`` (content-addressed by workload + HWSpec, memory
hierarchy included).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.memory import apply_mem_overrides
from repro_torch.core.schedule import CONFIG_STACK, evaluate_stack
from repro_torch.search import (WORKLOADS, auto_schedule, cached_search, dse,
                          get_workload, parse_workload, save_schedule)
from repro_torch.search.perf import PerfRecorder


def _workload_name(name: str) -> str:
    """Any registered base name, optionally with a ``-b<N>`` serving
    batch suffix (``edgenext-s-b16``, ``vit-tiny-b64``, ...)."""
    base, _ = parse_workload(name)
    if base not in WORKLOADS and name not in WORKLOADS:
        raise argparse.ArgumentTypeError(
            f"unknown workload {name!r} (bases: {', '.join(WORKLOADS)}; "
            f"any base takes a -b<N> batch suffix)")
    return name


def _build_hw(args: argparse.Namespace) -> HWSpec:
    over = {}
    for f in ("rows", "cols"):
        v = getattr(args, f)
        if v is not None:
            over[f] = v
    if args.sram_kb is not None:
        over["sram_bytes"] = args.sram_kb * 1024
        over["act_budget_bytes"] = int(args.sram_kb * 1024 * 3 / 8)
    if args.rf_kb is not None:
        over["output_rf_bytes"] = args.rf_kb * 1024
    hw = dataclasses.replace(HWSpec(), **over)
    if args.mem:
        hw = dataclasses.replace(
            hw, hierarchy=apply_mem_overrides(hw.hierarchy, args.mem))
    return hw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.search", description=__doc__)
    ap.add_argument("--workload", default="edgenext-s",
                    type=_workload_name, metavar="NAME",
                    help=f"one of {', '.join(WORKLOADS)}, each accepting "
                         f"a -b<N> serving-batch suffix")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the schedule artifact here")
    ap.add_argument("--cache-dir", type=Path, default=None,
                    help="content-addressed schedule cache directory")
    ap.add_argument("--dse", action="store_true",
                    help="sweep HWSpec variants and print the Pareto front")
    ap.add_argument("--mem", action="append", default=[],
                    metavar="NAME:BYTES[:PJ]",
                    help="resize / reprice one memory-hierarchy level "
                         "(repeatable), e.g. --mem sram:256kb or "
                         "--mem dram:0:80; partitions scale with the "
                         "level")
    ap.add_argument("--dse-mem", nargs="+", default=None, metavar="LEVEL",
                    help="sweep the named hierarchy levels over a "
                         "0.5x/1x/2x sizing grid and print the "
                         "(latency, energy) Pareto front")
    ap.add_argument("--golden", type=Path, default=None,
                    help="write the small golden-schedule snapshot "
                         "(groups + tiles + EDP) asserted by "
                         "tests/test_search.py — regenerate after "
                         "intentional cost-model changes")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--cols", type=int, default=None)
    ap.add_argument("--sram-kb", type=int, default=None)
    ap.add_argument("--rf-kb", type=int, default=None)
    ap.add_argument("--spatial-mode", choices=("factored", "pair"),
                    default="factored",
                    help="spatial mapspace: factored per-axis unrollings "
                         "with row/col replication (default) or the "
                         "ordered-dim-pair ablation")
    ap.add_argument("--profile", action="store_true",
                    help="print search-performance rows (perf.*): "
                         "per-phase wall time, memo hit rates, and the "
                         "wall-time speedup vs the dedup-off "
                         "brute-force baseline run in the same process")
    ap.add_argument("--no-dedup", action="store_true",
                    help="run the brute-force equivalence mode (no "
                         "unique-layer memo, full enumeration) — "
                         "bit-identical schedules, slower")
    ap.add_argument("--jobs", type=int, default=0, metavar="N",
                    help="process-pool fan-out for --dse/--dse-mem "
                         "sweeps (0 = serial with a shared sweep-wide "
                         "memo)")
    ap.add_argument("--trace", type=Path, default=None, metavar="OUT.json",
                    help="record a hierarchical span trace of the whole "
                         "run and write it as Chrome-trace JSON (load "
                         "in chrome://tracing or Perfetto); also "
                         "prints the search.obs.* provenance counters")
    ap.add_argument("--check", action="store_true",
                    help="run the repro_torch.check static verifier over the "
                         "searched schedule; exit nonzero on findings")
    ap.add_argument("--explain", action="store_true",
                    help="print the markdown schedule-explain report: "
                         "per-layer mapping decisions, per-level "
                         "traffic/energy breakdown, fusion groups (for "
                         "sweeps: the EDP-best point's schedule)")
    args = ap.parse_args(argv)
    if args.cache_dir and (args.no_dedup or args.profile):
        ap.error("--cache-dir replays artifacts and bypasses the "
                 "search, so --no-dedup/--profile would be silently "
                 "meaningless there; drop one side")
    if args.trace:
        with obs.tracing() as tracer:
            rc = _run(args, ap)
        obs.write_chrome_trace(tracer, args.trace)
        for name, value, note in obs.bench_rows(tracer):
            print(f"{name},{value:.6g},{note}")
        print(f"# wrote trace {args.trace} "
              f"({tracer.span_count()} spans)")
        return rc
    return _run(args, ap)


def _run(args: argparse.Namespace, ap: argparse.ArgumentParser) -> int:
    layers = get_workload(args.workload)
    hw = _build_hw(args)
    dedup = not args.no_dedup

    if args.dse_mem:
        sizings = {}
        for name in args.dse_mem:
            try:
                lvl = hw.hierarchy.level(name)
            except KeyError as e:
                ap.error(str(e.args[0]))
            if not lvl.bounded:
                ap.error(f"--dse-mem {name}: the unbounded backing "
                         f"store has no capacity to sweep; choose from "
                         f"{', '.join(l.name for l in hw.hierarchy.on_chip)}")
            sizings[name] = (lvl.bytes // 2, lvl.bytes, lvl.bytes * 2)
        perf = PerfRecorder()
        t0 = time.perf_counter()
        pts = dse.sweep_memory(layers, hw, sizings=sizings,
                               workload=args.workload, dedup=dedup,
                               perf=perf, parallel=args.jobs,
                               spatial_mode=args.spatial_mode)
        dt = time.perf_counter() - t0
        if args.profile:
            # baseline runs under the SAME execution mode (incl.
            # --jobs) so the ratio isolates the memo/pruning gain,
            # never the pool parallelism; results must stay identical
            t1 = time.perf_counter()
            pts_b = dse.sweep_memory(layers, hw, sizings=sizings,
                                     workload=args.workload,
                                     dedup=False, parallel=args.jobs,
                                     spatial_mode=args.spatial_mode)
            dt_brute = time.perf_counter() - t1
            assert [dataclasses.asdict(p.schedule) for p in pts] == \
                [dataclasses.asdict(p.schedule) for p in pts_b], \
                "dedup-on/off sweeps diverged — memoization bug"
            for name, value, note in perf.rows("perf"):
                print(f"{name},{value:.6g},{note}")
            print(f"perf.dse_mem.wall_ms,{dt * 1e3:.6g},dedup sweep")
            print(f"perf.dse_mem.speedup,{dt_brute / dt:.6g},"
                  f"vs dedup-off baseline ({dt_brute * 1e3:.0f} ms, "
                  f"same jobs setting)")
        front = dse.pareto_front(pts)
        best = dse.edp_best(pts)
        base_pt = next(p for p in pts
                       if all(hw.hierarchy.level(n).bytes == b
                              for n, b in p.mem))
        print(f"# hierarchy DSE {args.workload}: {len(pts)} sizings, "
              f"{len(front)} on the Pareto front")
        print("sizing,latency_ms,energy_mj,edp,edp_vs_base,on_front")
        on_front = {p.label for p in front}
        for p in sorted(pts, key=lambda p: p.edp):
            print(f"{p.label},{p.latency_s*1e3:.4g},{p.energy_j*1e3:.4g},"
                  f"{p.edp:.4g},{p.edp/base_pt.edp:.4f},"
                  f"{int(p.label in on_front)}")
        print(f"# EDP-best: {best.label} (edp={best.edp:.4g}, "
              f"{best.edp/base_pt.edp:.4f}x the base spec)")
        if args.explain:
            print(obs.explain_schedule(layers, best.schedule))
        return 0

    if args.dse:
        pts = dse.sweep(layers, dse.hw_variants(hw),
                        workload=args.workload, dedup=dedup,
                        parallel=args.jobs,
                        spatial_mode=args.spatial_mode)
        front = dse.pareto_front(pts)
        best = dse.edp_best(pts)
        print(f"# DSE {args.workload}: {len(pts)} variants, "
              f"{len(front)} on the Pareto front")
        print("variant,latency_ms,energy_mj,edp,on_front")
        on_front = {p.label for p in front}
        for p in sorted(pts, key=lambda p: p.edp):
            print(f"{p.label},{p.latency_s*1e3:.4g},{p.energy_j*1e3:.4g},"
                  f"{p.edp:.4g},{int(p.label in on_front)}")
        print(f"# EDP-best: {best.label} (edp={best.edp:.4g})")
        if args.explain:
            print(obs.explain_schedule(layers, best.schedule))
        if args.out:
            args.out.write_text(json.dumps({
                "workload": args.workload,
                "front": [{**{k: getattr(p, k) for k in
                              ("rows", "cols", "sram_kb", "rf_kb",
                               "latency_s", "energy_j", "edp")}}
                          for p in front],
                "edp_best": best.label}, indent=1))
            print(f"# wrote {args.out}")
        return 0

    perf = PerfRecorder()
    if args.cache_dir:
        sched = cached_search(layers, hw, workload=args.workload,
                              cache_dir=args.cache_dir,
                              spatial_mode=args.spatial_mode)
    else:
        t0 = time.perf_counter()
        sched = auto_schedule(layers, hw, workload=args.workload,
                              dedup=dedup, perf=perf,
                              spatial_mode=args.spatial_mode)
        dt = time.perf_counter() - t0
        if args.profile:
            t1 = time.perf_counter()
            brute = auto_schedule(layers, hw, workload=args.workload,
                                  dedup=False,
                                  spatial_mode=args.spatial_mode)
            dt_brute = time.perf_counter() - t1
            assert dataclasses.asdict(brute) == dataclasses.asdict(sched), \
                "dedup-on/off schedules diverged — memoization bug"
            for name, value, note in perf.rows("perf"):
                print(f"{name},{value:.6g},{note}")
            print(f"perf.auto.wall_ms,{dt * 1e3:.6g},dedup on")
            print(f"perf.auto.speedup,{dt_brute / dt:.6g},"
                  f"vs dedup-off baseline ({dt_brute * 1e3:.1f} ms), "
                  f"schedules bit-identical")

    if args.check:
        from repro_torch.check import verify_schedule
        findings = verify_schedule(layers, sched, source="cli")
        for f in findings:
            print(f"check,{f.code},{f.where},{f.detail}")
        print(f"# check: {'FAIL' if findings else 'ok'} "
              f"({len(findings)} findings)")
        if findings:
            return 1
    print(f"# auto-schedule {args.workload} on {hw.rows}x{hw.cols} PEs, "
          f"hierarchy {'/'.join(hw.hierarchy.names)}")
    print(f"groups={len(sched.groups)} spill_edges={len(sched.edges)} "
          f"fused_nonlinear={len(sched.fused_nonlinear)} "
          f"lowered_kernels={len(sched.lowered)}")
    for k, v in sched.cost.items():
        print(f"cost.{k},{v:.6g}")
    from repro_torch.core.schedule import level_breakdown
    from repro_torch.search import evaluate_schedule
    for name, d in level_breakdown(
            evaluate_schedule(layers, sched, hw)).items():
        print(f"level.{name},{d['bytes']:.6g}B,{d['energy_pj']:.6g}pJ")
    names = [n for n, _ in CONFIG_STACK]
    for r, name in zip(evaluate_stack(layers, hw), names):
        print(f"hand.{name}.edp,{r.edp:.6g}")
    if args.explain:
        print(obs.explain_schedule(layers, sched, hw))
    if args.out:
        save_schedule(sched, args.out)
        print(f"# wrote {args.out}")
    if args.golden:
        args.golden.parent.mkdir(parents=True, exist_ok=True)
        args.golden.write_text(json.dumps({
            "version": sched.version,
            "workload": sched.workload,
            "groups": [list(g) for g in sched.groups],
            "tiles": sched.tiles,
            "cost": {"edp": sched.cost["edp"],
                     "edp_tiled": sched.cost["edp_tiled"]},
        }, indent=1, sort_keys=True))
        print(f"# wrote golden snapshot {args.golden}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
