"""``repro_torch.check`` — static verification of schedule artifacts.

A schedule artifact is a claim: "this mapping fits the hardware, this
fusion is legal, these cost numbers follow from these traffic rows".
This package re-derives every part of that claim from first principles
— from the ``Layer`` shapes, the ``MemoryHierarchy``, and the artifact
document alone — sharing **no** helper with the search stack that
produced it, so a bug in the mapper, tiler, or cost model cannot
silently vouch for itself.

Three analyzers:

- :mod:`repro_torch.check.schedule` — capacity, spatial-mapping legality,
  fusion legality, and conservation checks over a ``Schedule``.
- :mod:`repro_torch.check.lint_lower` — Hopper launch-parameter lint over
  the ``lowered`` kernels (blocks on each kernel's compiled menu,
  shared-memory budgets, ragged-edge records).
- :mod:`repro_torch.check.races` — an exhaustive interleaving explorer for
  the artifact-store claim-lock protocol in ``search.cache``.

Plus :mod:`repro_torch.check.mutations`, a corpus of seeded artifact
corruptions each of which the checkers must catch, and a CLI
(``python -m repro_torch.check``) that exits nonzero on any finding.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch import obs
from repro_torch.check.lint_lower import KERNELS, lint_doc
from repro_torch.check.races import (ExploreResult, Violation, explore,
                               verify_protocol)
from repro_torch.check.schedule import (KNOWN_VERSIONS, Finding, check_doc,
                                  check_schedule)
from repro_torch.core.workload import Layer

__all__ = [
    "ExploreResult", "Finding", "KERNELS", "KNOWN_VERSIONS",
    "Violation", "check_artifact", "check_doc", "check_schedule",
    "explore", "lint_doc", "verify_protocol", "verify_schedule",
]


def check_artifact(doc: dict, layers: Optional[Sequence[Layer]] = None,
                   *, degraded: Optional[str] = None) -> List[Finding]:
    """All static findings for an artifact document: schedule checks
    plus the lowering lint.  ``layers`` defaults to resolving the
    document's ``workload`` name from the registry."""
    findings = check_doc(doc, layers, degraded=degraded)
    if layers is None:
        try:
            from repro_torch.search import get_workload
            layers = get_workload(doc.get("workload", ""))
        except (KeyError, ValueError):
            layers = None
    if layers is not None:
        findings += lint_doc(doc, layers)
    return findings


def verify_schedule(layers: Sequence[Layer], sched, *,
                    degraded: Optional[str] = None,
                    source: str = "replay") -> List[Finding]:
    """Verify a live ``Schedule`` object; returns the findings (empty
    on a clean pass) and keeps the ``check.pass`` / ``check.fail``
    counters.  This is the hook ``cached_search`` calls when
    verify-on-replay is enabled, and ``chip_smoke.py`` before it launches
    a schedule's lowered entries.  ``degraded`` is the marker of a
    serving store's degraded answer, which relaxes the checks such an
    answer cannot meet."""
    if degraded is None:
        degraded = getattr(sched, "degraded", None)
    findings = check_schedule(layers, sched, degraded=degraded)
    if degraded is None:
        # degraded answers carry the neighbor batch's (or no) launch
        # params; only the full searched schedule is lintable
        import dataclasses
        findings += lint_doc(dataclasses.asdict(sched), layers)
    if findings:
        obs.count("check.fail")
        obs.event("check.verify", ok=False, source=source,
                  workload=getattr(sched, "workload", "?"),
                  n=len(findings), first=str(findings[0]))
    else:
        obs.count("check.pass")
        obs.event("check.verify", ok=True, source=source,
                  workload=getattr(sched, "workload", "?"))
    return findings
