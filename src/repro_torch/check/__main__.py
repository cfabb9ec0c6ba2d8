"""CLI: statically verify schedule artifacts.

    PYTHONPATH=src python -m repro_torch.check schedule.json [...]
    PYTHONPATH=src python -m repro_torch.check --cache-dir .cache/schedules
    PYTHONPATH=src python -m repro_torch.check --workload edgenext-s
    PYTHONPATH=src python -m repro_torch.check --mutation-corpus
    PYTHONPATH=src python -m repro_torch.check --races

Every finding prints one machine-readable line
(``check,<code>,<where>,<target>,<detail>``); ``--json`` emits a JSON
report instead.  Exit code is nonzero when any finding (or uncaught
mutation, or protocol violation) survives.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.check import check_artifact, verify_protocol, verify_schedule
from repro_torch.check.mutations import MUTATIONS, run_corpus


def _check_file(path: Path):
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        from repro_torch.check import Finding
        return [Finding("artifact.unreadable", path.name, str(e))]
    return check_artifact(doc)


def _report(target: str, findings, as_json: bool, out) -> None:
    if as_json:
        out.append({"target": target,
                    "findings": [{"code": f.code, "where": f.where,
                                  "detail": f.detail}
                                 for f in findings]})
        return
    for f in findings:
        print(f"check,{f.code},{f.where},{target},{f.detail}")
    status = "FAIL" if findings else "ok"
    print(f"# {target}: {status} ({len(findings)} findings)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.check", description=__doc__)
    ap.add_argument("artifacts", nargs="*", type=Path,
                    help="schedule artifact JSON files to verify")
    ap.add_argument("--cache-dir", type=Path, default=None,
                    help="verify every *.json artifact in a cache dir")
    ap.add_argument("--workload", default=None, metavar="NAME",
                    help="search the workload fresh and verify the "
                         "resulting schedule in memory")
    ap.add_argument("--mutation-corpus", action="store_true",
                    help="apply every seeded mutation to clean base "
                         "artifacts; fail unless all are caught")
    ap.add_argument("--races", action="store_true",
                    help="exhaustively explore the claim-lock protocol "
                         "interleavings (N=2..3, with crashes)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON report instead of CSV lines")
    args = ap.parse_args(argv)
    if not (args.artifacts or args.cache_dir or args.workload
            or args.mutation_corpus or args.races):
        ap.error("nothing to check: give artifact paths, --cache-dir, "
                 "--workload, --mutation-corpus, or --races")

    bad = 0
    out = []

    for path in args.artifacts:
        findings = _check_file(path)
        bad += len(findings)
        _report(str(path), findings, args.json, out)

    if args.cache_dir:
        paths = sorted(args.cache_dir.glob("*.json"))
        if not paths:
            print(f"# no artifacts under {args.cache_dir}",
                  file=sys.stderr)
            bad += 1
        for path in paths:
            findings = _check_file(path)
            bad += len(findings)
            _report(str(path), findings, args.json, out)

    if args.workload:
        from repro_torch.search import auto_schedule, get_workload
        layers = get_workload(args.workload)
        sched = auto_schedule(layers, workload=args.workload)
        findings = verify_schedule(layers, sched, source="cli")
        bad += len(findings)
        _report(f"workload:{args.workload}", findings, args.json, out)

    if args.mutation_corpus:
        results, base_findings = run_corpus()
        for wl, findings in sorted(base_findings.items()):
            if findings:
                bad += len(findings)
                _report(f"corpus-base:{wl}", findings, args.json, out)
        caught = 0
        for r in results:
            if r.caught:
                caught += 1
                first = r.findings[0]
                line = f"caught by {first.code}"
            else:
                bad += 1
                line = ("NOT APPLIED" if not r.applied
                        else "NOT CAUGHT")
            if args.json:
                out.append({"mutation": r.mutation,
                            "workload": r.workload,
                            "caught": r.caught, "detail": line})
            else:
                print(f"mutation,{r.mutation},{r.workload},"
                      f"{'ok' if r.caught else 'FAIL'},{line}")
        if not args.json:
            print(f"# mutation corpus: {caught}/{len(MUTATIONS)} caught")

    if args.races:
        results = verify_protocol(max_n=3)
        for r in results:
            label = (f"races:n={r.n},crashes={r.max_crashes},"
                     f"{r.protocol}")
            if r.violations:
                bad += len(r.violations)
            if args.json:
                out.append({"target": label, "states": r.states,
                            "violations": [
                                {"kind": v.kind, "trace": list(v.trace)}
                                for v in r.violations]})
            else:
                status = "FAIL" if r.violations else "ok"
                print(f"race,{label},{status},{r.states} states,"
                      f"{r.terminals} terminals")
                for v in r.violations:
                    print(f"race,{label},violation,{v.kind},"
                          f"{' -> '.join(v.trace)}")
        if not args.json:
            n_bad = sum(len(r.violations) for r in results)
            print(f"# race explorer: {len(results)} configs, "
                  f"{n_bad} violations")

    if args.json:
        print(json.dumps({"ok": bad == 0, "reports": out}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
