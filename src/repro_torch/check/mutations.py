"""Seeded artifact mutations that prove the checker's teeth.

Each mutation takes a *clean* searched artifact document and applies
one realistic corruption — an inflated tile, a spatially split scan
carry dim, a dropped ragged mask, a tampered cost row — that the
static checker (``check.schedule`` + ``check.lint_lower``) must catch.
``run_corpus`` builds the base artifacts, asserts they are clean,
applies every mutation to a fresh copy, and reports which were caught;
the test suite and ``chip_smoke.py`` require *all* of them to be.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.check.lint_lower import lint_doc
from repro_torch.check.schedule import Finding, check_doc


@dataclasses.dataclass(frozen=True)
class Mutation:
    name: str
    workload: str
    note: str
    apply: Callable[[dict, list], bool]   # (doc, layers) -> applied?


@dataclasses.dataclass
class CorpusResult:
    mutation: str
    workload: str
    applied: bool
    findings: List[Finding]

    @property
    def caught(self) -> bool:
        return self.applied and bool(self.findings)


def _group_tile(doc) -> Tuple[Optional[str], Optional[dict]]:
    for n, t in (doc.get("tiles") or {}).items():
        if "tile_x" in t:
            return n, t
    return None, None


def _scan_name(layers) -> Optional[str]:
    return next((l.name for l in layers if l.op == "scan"), None)


def _first_mac(layers) -> Optional[str]:
    return next((l.name for l in layers
                 if l.op in ("conv", "dwconv", "pwconv", "matmul")),
                None)


def _lowered_with(doc, param) -> Optional[dict]:
    for v in (doc.get("lowered") or {}).values():
        if param in v:
            return v
    return None


def _mut_inflate_tile_x(doc, layers):
    _, t = _group_tile(doc)
    if t is None:
        return False
    t["tile_x"] = int(t["tile_x"]) * 2
    return True


def _mut_inflate_buffer(doc, layers):
    _, t = _group_tile(doc)
    if t is None or "buffer_bytes" not in t:
        return False
    t["buffer_bytes"] = int(t["buffer_bytes"]) * 4
    return True


def _mut_tamper_sram_traffic(doc, layers):
    _, t = _group_tile(doc)
    if t is None or "sram_traffic" not in t:
        return False
    t["sram_traffic"] = int(t["sram_traffic"]) + 12345
    return True


def _mut_split_carry_dim(doc, layers):
    name = _scan_name(layers)
    if name is None or name not in (doc.get("mappings") or {}):
        return False
    doc["mappings"][name] = ["ox", "c"]     # carry dim on the array rows
    return True


def _mut_scan_state_tamper(doc, layers):
    name = _scan_name(layers)
    t = (doc.get("tiles") or {}).get(name)
    if not t or "state_bytes" not in t:
        return False
    t["state_bytes"] = int(t["state_bytes"]) * 2
    return True


def _mut_dup_reduction_axis(doc, layers):
    mac = _first_mac(layers)
    if mac is None or mac not in (doc.get("mappings") or {}):
        return False
    doc["mappings"][mac] = [[["c", 2]], [["c", 2]]]
    return True


def _mut_reduction_not_innermost(doc, layers):
    mac = _first_mac(layers)
    if mac is None or mac not in (doc.get("mappings") or {}):
        return False
    doc["mappings"][mac] = [[["c", 2], ["ox", 2]], []]
    return True


def _mut_overflow_axis(doc, layers):
    mac = _first_mac(layers)
    if mac is None or mac not in (doc.get("mappings") or {}):
        return False
    doc["mappings"][mac] = [[["ox", 1024]], [["c", 2]]]
    return True


def _mut_pair_same_dim(doc, layers):
    mac = _first_mac(layers)
    if mac is None or mac not in (doc.get("mappings") or {}):
        return False
    doc["mappings"][mac] = ["c", "c"]
    return True


def _mut_drop_mask(doc, layers):
    for v in (doc.get("lowered") or {}).values():
        for axis, r in list((v.get("ragged") or {}).items()):
            if r:
                del v["ragged"][axis]
                return True
    return False


def _mut_stale_ragged(doc, layers):
    for v in (doc.get("lowered") or {}).values():
        for axis, r in (v.get("ragged") or {}).items():
            v["ragged"][axis] = int(r) + 1
            return True
    return False


def _mut_oversize_block(doc, layers):
    for param in ("block_m", "block_q"):
        v = _lowered_with(doc, param)
        if v is not None:
            v[param] = 1024
            return True
    return False


def _mut_non_pow2_block(doc, layers):
    for param in ("block_m", "block_q"):
        v = _lowered_with(doc, param)
        if v is not None:
            v[param] = 24
            return True
    return False


def _mut_tamper_latency(doc, layers):
    cost = doc.get("cost") or {}
    if "latency_s" not in cost:
        return False
    cost["latency_s"] = float(cost["latency_s"]) * 1.5
    return True


def _mut_tamper_energy(doc, layers):
    cost = doc.get("cost") or {}
    if "energy_j" not in cost:
        return False
    cost["energy_j"] = float(cost["energy_j"]) * 0.5
    return True


def _mut_tamper_dram(doc, layers):
    cost = doc.get("cost") or {}
    if "dram_bytes" not in cost:
        return False
    cost["dram_bytes"] = float(cost["dram_bytes"]) + 1e6
    return True


def _mut_drop_spill_edge(doc, layers):
    edges = doc.get("edges")
    if not edges:
        return False
    edges.pop(0)
    return True


def _mut_inflate_edge_bytes(doc, layers):
    edges = doc.get("edges")
    if not edges:
        return False
    p, c, nb = edges[0]
    edges[0] = [p, c, int(nb) * 2]
    return True


def _mut_unfuse_reorder(doc, layers):
    fused = list(doc.get("fused_nonlinear") or ())
    if not fused:
        return False
    fused.pop()
    doc["fused_nonlinear"] = fused
    return True


def _mut_budget_overflow(doc, layers):
    _, t = _group_tile(doc)
    if t is None or "level" not in t or "buffer_bytes" not in t:
        return False
    for lvl in doc["hw"]["hierarchy"]["levels"]:
        if lvl["name"] == t["level"]:
            lvl["bytes"] = max(1, int(t["buffer_bytes"]) // 2)
            lvl["partitions"] = {}
            return True
    return False


def _mut_version_unknown(doc, layers):
    doc["version"] = 99
    return True


MUTATIONS: Tuple[Mutation, ...] = (
    Mutation("inflate_tile_x", "edgenext-s",
             "tile_x doubled, derived tile stats now stale",
             _mut_inflate_tile_x),
    Mutation("inflate_buffer_bytes", "edgenext-s",
             "recorded footprint no longer matches the tile",
             _mut_inflate_buffer),
    Mutation("tamper_sram_traffic", "edgenext-s",
             "tile traffic row inflated", _mut_tamper_sram_traffic),
    Mutation("dup_reduction_axis", "edgenext-s",
             "reduction dim spatially split across both axes",
             _mut_dup_reduction_axis),
    Mutation("reduction_not_innermost", "edgenext-s",
             "reduction factor not innermost on its axis",
             _mut_reduction_not_innermost),
    Mutation("overflow_axis", "edgenext-s",
             "axis unroll exceeds the PE rows", _mut_overflow_axis),
    Mutation("pair_same_dim", "edgenext-s",
             "row and column map the same dim", _mut_pair_same_dim),
    Mutation("drop_mask", "edgenext-s",
             "ragged edge left without an in-kernel mask record",
             _mut_drop_mask),
    Mutation("stale_ragged", "edgenext-s",
             "ragged remainder contradicts extent % block",
             _mut_stale_ragged),
    Mutation("oversize_block", "edgenext-s",
             "launch block off the kernel's menu (1024)", _mut_oversize_block),
    Mutation("non_pow2_block", "edgenext-s",
             "launch block off the kernel's menu (24)", _mut_non_pow2_block),
    Mutation("tamper_latency", "edgenext-s",
             "headline latency inflated", _mut_tamper_latency),
    Mutation("tamper_energy", "edgenext-s",
             "headline energy halved", _mut_tamper_energy),
    Mutation("tamper_dram", "edgenext-s",
             "DRAM traffic aggregate tampered", _mut_tamper_dram),
    Mutation("drop_spill_edge", "edgenext-s",
             "over-budget group boundary lost its spill edge",
             _mut_drop_spill_edge),
    Mutation("inflate_edge_bytes", "edgenext-s",
             "spill edge bytes no longer the boundary tensor",
             _mut_inflate_edge_bytes),
    Mutation("unfuse_reorder", "edgenext-s",
             "fused nonlinear dropped from the fused set",
             _mut_unfuse_reorder),
    Mutation("budget_overflow", "edgenext-s",
             "residence level shrunk below the tile footprint",
             _mut_budget_overflow),
    Mutation("version_unknown", "edgenext-s",
             "artifact from an unknown search version",
             _mut_version_unknown),
    Mutation("split_carry_dim", "rwkv6",
             "scan carry/sequence dim spatially split",
             _mut_split_carry_dim),
    Mutation("scan_state_tamper", "rwkv6",
             "carry-state bytes no longer 4*c*k",
             _mut_scan_state_tamper),
)


def build_base_doc(workload: str, cache_dir=None):
    """A fresh searched artifact for ``workload`` in raw-JSON form (the
    exact shape a replayed artifact file has)."""
    from repro_torch.search import get_workload
    from repro_torch.search.cache import cached_search
    layers = get_workload(workload)
    sched = cached_search(layers, workload=workload,
                          cache_dir=cache_dir)
    doc = json.loads(json.dumps(dataclasses.asdict(sched)))
    return list(layers), doc


def run_corpus(cache_dir=None) -> Tuple[List[CorpusResult],
                                        Dict[str, List[Finding]]]:
    """Run every mutation against a clean base artifact.  Returns the
    per-mutation results plus the base artifacts' own findings (which
    must be empty for the corpus to mean anything)."""
    bases: Dict[str, tuple] = {}
    base_findings: Dict[str, List[Finding]] = {}
    for m in MUTATIONS:
        if m.workload not in bases:
            layers, doc = build_base_doc(m.workload, cache_dir)
            bases[m.workload] = (layers, doc)
            base_findings[m.workload] = (check_doc(doc, layers)
                                         + lint_doc(doc, layers))
    results = []
    for m in MUTATIONS:
        layers, base = bases[m.workload]
        doc = copy.deepcopy(base)
        applied = m.apply(doc, layers)
        findings = (check_doc(doc, layers) + lint_doc(doc, layers)
                    if applied else [])
        results.append(CorpusResult(m.name, m.workload, applied,
                                    findings))
    return results, base_findings
