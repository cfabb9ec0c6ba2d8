"""The port's static schedule checker against the JAX package's, on the CPU.

``repro_torch.check`` is a copy of ``repro.check`` except for the launch
lint, which restates the Hopper contract of the port's kernels instead of
the TPU one.  Here: the checker's findings on the port's schedules equal
the reference's on the reference's (all 11 workloads, and 17 seeded
corruptions that do not touch ``lowered``), the mutation corpus is caught
21/21 on the port's artifacts, the Hopper lint passes every port
``lowered`` entry and flags the reference's TPU blocks, its constants
equal the kernel wrappers', verify-on-replay is a pure read that repairs a
bad artifact (in ``cached_search`` and in ``ServeStore(verify=True)``),
the serving ladder's degraded answers pass the checks they can meet, the
claim-lock explorer gives the reference's results, and the CLI gives the
reference's exit codes.
"""
import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro.check as jcheck
import repro.check.mutations as jmut
import repro.check.races as jraces
import repro.search as jsearch
from repro_torch import obs
from repro_torch import search as tsearch
from repro_torch.check import (check_artifact, check_doc, lint_doc,
                               verify_schedule)
from repro_torch.check import lint_lower
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.mutations import MUTATIONS, build_base_doc, run_corpus
from repro_torch.check.races import explore, verify_protocol
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.workload import Layer
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import fused_ibn as t_ibn
from repro_torch.kernels import matmul_ln as t_mln
from repro_torch.kernels import rwkv_chunk as t_wkv
from repro_torch.search.cache import (_claim_store, _release_store,
                                      cached_search)
from repro_torch.serve.store import ServeStore, heuristic_schedule

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = sorted((ROOT / "tests" / "golden").glob("*.json"))
LOWERED_MUTATIONS = ("drop_mask", "stale_ragged", "oversize_block",
                     "non_pow2_block")
_TINY = [Layer("l0", "pwconv", k=8, c=8, ox=4, oy=4),
         Layer("l1", "dwconv", c=8, ox=4, oy=4, fx=3, fy=3)]


def _plain(findings):
    return [(f.code, f.where, f.detail) for f in findings]


def _doc(sched):
    """The raw JSON form an artifact file holds."""
    return json.loads(json.dumps(dataclasses.asdict(sched)))


@functools.lru_cache(maxsize=None)
def _schedules(name):
    """(JAX layers, JAX Schedule, port layers, port Schedule)."""
    jl = jsearch.get_workload(name)
    tl = tsearch.get_workload(name)
    return (jl, jsearch.auto_schedule(jl, workload=name),
            tl, tsearch.auto_schedule(tl, workload=name))


@functools.lru_cache(maxsize=None)
def _base_docs(workload):
    """Each package's own clean corpus base artifact for a workload."""
    return jmut.build_base_doc(workload), build_base_doc(workload)


# ---------------------------------------------------------------------------
# parity with the reference checker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jsearch.WORKLOADS)
def test_findings_equal_the_reference_on_every_workload(name):
    jl, js, tl, ts = _schedules(name)
    want = _plain(jcheck.check_doc(_doc(js), jl))
    got = _plain(check_doc(_doc(ts), tl))
    assert got == want == []
    # the Hopper lint passes every port lowered entry
    assert ts.lowered and lint_doc(_doc(ts), tl) == []
    assert verify_schedule(tl, ts, source="test") == []


_NON_LOWERED = [m.name for m in MUTATIONS if m.name not in LOWERED_MUTATIONS]


def test_the_corpus_is_the_reference_corpus():
    assert [(m.name, m.workload) for m in MUTATIONS] == \
        [(m.name, m.workload) for m in jmut.MUTATIONS]
    assert len(MUTATIONS) == 21 and len(_NON_LOWERED) == 17


@pytest.mark.parametrize("mutation", _NON_LOWERED)
def test_mutation_findings_equal_the_reference(mutation):
    """Each corruption that leaves ``lowered`` alone, applied to each
    package's own artifact, gives the same findings, code for code."""
    tm = next(m for m in MUTATIONS if m.name == mutation)
    jm = next(m for m in jmut.MUTATIONS if m.name == mutation)
    (jl, jbase), (tl, tbase) = _base_docs(tm.workload)
    jdoc, tdoc = copy.deepcopy(jbase), copy.deepcopy(tbase)
    assert jm.apply(jdoc, jl) and tm.apply(tdoc, tl)
    want = _plain(jcheck.check_doc(jdoc, jl) + jcheck.lint_doc(jdoc, jl))
    got = _plain(check_doc(tdoc, tl) + lint_doc(tdoc, tl))
    assert want and got == want


def test_mutation_corpus_all_caught(tmp_path):
    results, base_findings = run_corpus(cache_dir=tmp_path)
    for wl, findings in base_findings.items():
        assert findings == [], f"base artifact for {wl} not clean"
    assert [r.mutation for r in results if r.applied] == \
        [m.name for m in MUTATIONS]
    assert [r.mutation for r in results if not r.caught] == []
    # the port's artifacts, under the port's own cache names
    assert sorted(p.name.split("-hopper-")[0]
                  for p in tmp_path.glob("*-hopper-*.json")) == \
        ["edgenext-s", "rwkv6"]


@pytest.mark.parametrize("mutation,code", [
    ("drop_mask", "lint.mask_missing"),
    ("stale_ragged", "lint.ragged_stale"),
    ("oversize_block", "lint.block_menu"),
    ("non_pow2_block", "lint.block_menu"),
])
def test_lowered_mutations_are_caught_by_the_hopper_lint(mutation, code):
    m = next(m for m in MUTATIONS if m.name == mutation)
    layers, base = _base_docs(m.workload)[1]
    doc = copy.deepcopy(base)
    assert m.apply(doc, layers)
    assert check_doc(doc, layers) == []        # only the lint sees it
    assert code in {f.code for f in lint_doc(doc, layers)}


# ---------------------------------------------------------------------------
# the Hopper lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jsearch.WORKLOADS)
def test_the_lint_flags_the_reference_tpu_blocks(name):
    """A JAX-produced ``lowered`` carries TPU blocks (fused_ibn block_m
    128 / 256, matmul_ln block_k 128, ...) that no Hopper kernel is
    compiled for."""
    jl, js, tl, _ = _schedules(name)
    codes = {f.code for f in lint_doc(_doc(js), tl)}
    assert "lint.block_menu" in codes
    # and the reference's own lint passes it
    assert jcheck.lint_doc(_doc(js), jl) == []


def test_a_reference_artifact_file_fails_the_port_checker(tmp_path):
    jl = jsearch.get_workload("edgenext-s")
    jsearch.cached_search(jl, workload="edgenext-s", cache_dir=tmp_path)
    art, = tmp_path.glob("edgenext-s-*.json")
    doc = json.loads(art.read_text())
    assert jcheck.check_artifact(doc) == []
    assert check_doc(doc) == []
    assert "lint.block_menu" in {f.code for f in check_artifact(doc)}
    assert check_main([str(art)]) == 1


def test_the_lint_constants_are_the_kernel_wrappers():
    assert lint_lower.FUSED_IBN_BLOCKS == t_ibn.BLOCKS
    assert lint_lower.FLASH_ATTENTION_BLOCKS == t_fa.BLOCKS
    assert lint_lower.MATMUL_LN_BLOCK_M == t_mln.BLOCK_M
    assert lint_lower.MATMUL_LN_BLOCK_K == t_mln.BLOCK_K
    assert lint_lower.MATMUL_LN_SMEM_BYTES == t_mln.SMEM_BYTES
    for bm in t_mln.BLOCK_M:
        for n in (96, 2048, 2560, 4096):
            assert (bm * n * 4 <= lint_lower.MATMUL_LN_SMEM_BYTES) == \
                (t_mln.row_bytes(bm, n) <= t_mln.SMEM_BYTES)
    assert lint_lower.WKV_CHUNK == t_wkv.CHUNK
    assert lint_lower.WKV_SMEM_LIMIT == t_wkv.SMEM_LIMIT
    assert (lint_lower.WKV_BVS, lint_lower.WKV_TILE) == (t_wkv.BVS,
                                                        t_wkv.TILE)
    for chunk in (1, 7, 8, 16, 31, 32, 33, 64, 100, 128, 256, 512):
        for k in (1, 3, 8, 60, 64, 128, 1024):
            assert lint_lower.wkv_smem_bytes(chunk, k) == \
                t_wkv.smem_bytes(chunk, k), (chunk, k)


def _entry_doc(name, kernel):
    """The port's schedule document of a workload with one lowered entry
    of ``kernel`` left in ``lowered``: (layers, doc, key)."""
    _, _, tl, ts = _schedules(name)
    doc = _doc(ts)
    key = next(k for k, v in doc["lowered"].items() if v["kernel"] == kernel)
    doc["lowered"] = {key: doc["lowered"][key]}
    return tl, doc, key


@pytest.mark.parametrize("kernel,change,code", [
    ("fused_ibn", {"block_f": 128}, "lint.block_menu"),
    ("fused_ibn", {"block_m": "64x"}, "lint.block_type"),
    ("fused_ibn", {"block_m": 0}, "lint.block_range"),
    ("flash_attention", {"block_k": 64}, "lint.block_menu"),
    ("matmul_ln", {"block_k": 128}, "lint.block_menu"),
    ("matmul_ln", {"block_m": 12}, "lint.block_menu"),
    ("rwkv_chunk", {"chunk": 64}, "lint.scan_chunk"),
    ("rwkv_chunk", {"chunk": 0}, "lint.scan_chunk"),
    ("rwkv_chunk", {"bh": 7}, "lint.scan_shape"),
    ("rwkv_chunk", {"kernel": "wkv"}, "lint.unknown_kernel"),
])
def test_the_lint_flags_what_the_kernels_do_not_run(kernel, change, code):
    name = "rwkv6" if kernel == "rwkv_chunk" else "edgenext-s"
    layers, doc, key = _entry_doc(name, kernel)
    assert lint_doc(doc, layers) == []
    doc["lowered"][key].update(change)
    assert code in {f.code for f in lint_doc(doc, layers)}


def test_the_lint_holds_the_shared_memory_budgets():
    layers, doc, key = _entry_doc("rwkv6", "matmul_ln")
    entry = doc["lowered"][key]
    n = next(l for l in layers if l.name == key.split(" + ")[0]).k
    assert entry["block_m"] * n * 4 <= lint_lower.MATMUL_LN_SMEM_BYTES
    entry.update(block_m=64, ragged={"m": 0, "k": entry["ragged"]["k"]})
    assert 64 * n * 4 > lint_lower.MATMUL_LN_SMEM_BYTES
    assert [f.code for f in lint_doc(doc, layers)] == ["lint.smem"]
    # a scan whose chunk does not fit the outputs pass's shared memory
    wide = [Layer("s", "scan", b=2, c=1024, k=64, ox=64)]
    entry = {"kernel": "rwkv_chunk", "chunk": 32, "bh": 2, "t": 64,
             "k": 1024, "v": 64, "ragged": {}}
    assert lint_lower.wkv_smem_bytes(32, 1024) > lint_lower.WKV_SMEM_LIMIT
    assert [f.code for f in lint_doc({"lowered": {"s": entry}}, wide)] == \
        ["lint.smem"]


def test_blocks_past_their_extent_pass_with_their_ragged_record():
    """The Hopper kernels take true extents: a block larger than its
    extent is legal (the reference's ``lint.block_extent`` is gone) as
    long as ``ragged`` holds the extent itself."""
    layers, doc, key = _entry_doc("edgenext-s", "flash_attention")
    entry = doc["lowered"][key]
    seq = tsearch.lower.launch_shape(layers, key, entry)["k"]
    assert seq < entry["block_k"] and entry["ragged"]["k"] == seq
    assert lint_doc(doc, layers) == []
    del entry["ragged"]["k"]
    assert [f.code for f in lint_doc(doc, layers)] == ["lint.mask_missing"]


def test_the_lint_asks_for_no_entry_the_lowering_leaves_out():
    """Where ``search.lower`` leaves a group unlowered (a matmul_ln too
    wide for its row budget, a group with no kernel), nothing is asked of
    it: any subset of the emitted entries lints clean."""
    _, _, tl, ts = _schedules("recurrentgemma")
    doc = _doc(ts)
    items = list(doc["lowered"].items())
    for keep in (items[::2], items[1::3], []):
        doc["lowered"] = dict(keep)
        assert lint_doc(doc, tl) == []


# ---------------------------------------------------------------------------
# ports of the reference's tests/test_check.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("golden", GOLDENS, ids=lambda p: p.stem)
def test_goldens_verify_clean(golden):
    doc = json.loads(golden.read_text())
    assert "lowered" not in doc
    assert check_doc(doc) == [] and check_artifact(doc) == []
    assert jcheck.check_doc(doc) == []


@pytest.mark.parametrize("workload", ("edgenext-s-b16", "rwkv6-b4"))
def test_searched_batched_schedules_verify_clean(workload):
    layers = tsearch.get_workload(workload)
    sched = tsearch.auto_schedule(layers, workload=workload)
    assert verify_schedule(layers, sched, source="test") == []


@pytest.mark.parametrize("workload", ("edgenext-s", "rwkv6"))
def test_heuristic_schedule_verifies(workload):
    """Rung 5 of the serving ladder passes the conservation checks; its
    ``lowered`` is empty, so the launch lint has nothing to read."""
    layers = tsearch.get_workload(workload)
    sched = heuristic_schedule(layers, workload=workload)
    assert getattr(sched, "degraded", None) == "heuristic"
    assert sched.lowered == {}
    assert verify_schedule(layers, sched, source="test") == []


def test_nearest_batch_rescale_verifies(tmp_path, monkeypatch):
    """Rung 4 of the serving ladder: warm one batch level, fail the cold
    search for another, and check the rescaled answer against the
    *requested* batch's layers.  It carries the neighbour's launch
    parameters, which its ``degraded`` marker keeps from the lint."""
    from repro_torch.serve import chaos as chaos_mod
    store = ServeStore(tmp_path, HWSpec())
    store.lookup("edgenext-s", 4)

    def boom():
        raise RuntimeError("injected search failure")

    monkeypatch.setattr(chaos_mod, "on_search_attempt", boom)
    res = store.request("edgenext-s", 16)
    assert res.outcome == "nearest_batch" and res.degraded
    layers = tsearch.get_workload("edgenext-s-b16")
    assert verify_schedule(layers, res.schedule, source="test") == []


def test_artifact_roundtrip_verifies_clean(tmp_path):
    """The raw JSON an artifact file holds (tuples -> lists) verifies
    identically to the live Schedule."""
    layers = tsearch.get_workload("edgenext-s")
    sched = cached_search(layers, workload="edgenext-s", cache_dir=tmp_path)
    art, = tmp_path.glob("edgenext-s-hopper-*.json")
    doc = json.loads(art.read_text())
    assert check_artifact(doc) == []
    assert check_artifact(doc, layers) == []
    assert lint_doc(doc, layers) == []
    assert dataclasses.asdict(sched)["key"] == doc["key"]


def test_cached_search_verify_bit_identical(tmp_path):
    layers = tsearch.get_workload("edgenext-reduced")
    base = cached_search(layers, workload="edgenext-reduced",
                         cache_dir=tmp_path)
    with obs.tracing() as tr:
        plain = cached_search(layers, workload="edgenext-reduced",
                              cache_dir=tmp_path)
        checked = cached_search(layers, workload="edgenext-reduced",
                                cache_dir=tmp_path, verify=True)
    assert dataclasses.asdict(plain) == dataclasses.asdict(base)
    assert dataclasses.asdict(checked) == dataclasses.asdict(base)
    assert tr.counters.get("check.pass") == 1
    assert not tr.counters.get("check.fail")


@pytest.mark.parametrize("tamper", ["cost", "lowered"])
def test_cached_search_verify_fail_repairs_artifact(tmp_path, tamper):
    """A loadable but statically invalid artifact (a tampered cost row,
    or a launch block no Hopper kernel runs) fails verification, is
    searched again and overwritten with the repaired schedule, which then
    replays clean."""
    layers = tsearch.get_workload("edgenext-reduced")
    base = cached_search(layers, workload="edgenext-reduced",
                         cache_dir=tmp_path)
    art, = tmp_path.glob("edgenext-reduced-hopper-*.json")
    doc = json.loads(art.read_text())
    if tamper == "cost":
        doc["cost"]["latency_s"] *= 7.0
    else:
        entry = next(v for v in doc["lowered"].values() if "block_m" in v)
        entry["block_m"] = 256
    art.write_text(json.dumps(doc))
    with obs.tracing() as tr:
        repaired = cached_search(layers, workload="edgenext-reduced",
                                 cache_dir=tmp_path, verify=True)
    assert tr.counters.get("check.fail") == 1
    assert tr.counters.get("cache.miss") == 1
    assert tr.counters.get("cache.store") == 1
    outcomes = [sp.attrs.get("outcome") for r in tr.roots
                for sp in r.walk() if sp.name == "cache.replay"]
    assert outcomes == ["hit", "verify_fail", "miss"]
    assert dataclasses.asdict(repaired) == dataclasses.asdict(base)
    with obs.tracing() as tr2:
        again = cached_search(layers, workload="edgenext-reduced",
                              cache_dir=tmp_path, verify=True)
    assert tr2.counters.get("check.pass") == 1
    assert dataclasses.asdict(again) == dataclasses.asdict(base)


def test_servestore_verify_falls_back_to_search(tmp_path):
    """A ServeStore built with verify=True treats a tampered disk
    artifact as a miss: the request is served by a fresh search, not
    the bad replay."""
    layers = tsearch.get_workload("edgenext-reduced")
    base = cached_search(layers, workload="edgenext-reduced",
                         cache_dir=tmp_path)
    art, = tmp_path.glob("edgenext-reduced-hopper-*.json")
    doc = json.loads(art.read_text())
    doc["cost"]["energy_j"] *= 0.1
    art.write_text(json.dumps(doc))
    store = ServeStore(tmp_path, HWSpec(), verify=True)
    with obs.tracing() as tr:
        res = store.request("edgenext-reduced")
    assert res.outcome == "searched" and not res.degraded
    assert tr.counters.get("check.fail") == 1
    assert dataclasses.asdict(res.schedule) == dataclasses.asdict(base)
    # the repaired schedule also overwrote the bad artifact on disk
    assert check_artifact(json.loads(art.read_text()), layers) == []
    # now resident in memory: no re-verification, no disk touch
    assert store.request("edgenext-reduced").outcome == "mem"


def test_servestore_verify_off_by_default(tmp_path):
    store = ServeStore(tmp_path, HWSpec())
    assert store.verify is False
    with obs.tracing() as tr:
        store.lookup("edgenext-reduced")
        store.evict("edgenext-reduced")
        store.lookup("edgenext-reduced")       # disk replay, unverified
    assert tr.counters.get("cache.hit") == 1
    assert not tr.counters.get("check.pass")
    assert not tr.counters.get("check.fail")


def test_cli_clean_and_tampered_artifact(tmp_path):
    layers = tsearch.get_workload("edgenext-reduced")
    cached_search(layers, workload="edgenext-reduced", cache_dir=tmp_path)
    assert check_main(["--cache-dir", str(tmp_path)]) == 0
    art, = tmp_path.glob("edgenext-reduced-hopper-*.json")
    doc = json.loads(art.read_text())
    doc["cost"]["edp"] *= 3.0
    art.write_text(json.dumps(doc))
    assert check_main([str(art)]) == 1
    assert check_main(["--cache-dir", str(tmp_path)]) == 1


def test_cli_requires_a_target():
    with pytest.raises(SystemExit):
        check_main([])


def _run_cli(pkg, *args, cwd):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", f"{pkg}.check", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_exit_codes_equal_the_reference(tmp_path):
    """``python -m repro_torch.check`` exits as ``python -m repro.check``
    does on a clean artifact, a tampered one and no target."""
    dirs = {}
    for pkg, search in (("repro", jsearch), ("repro_torch", tsearch)):
        d = dirs[pkg] = tmp_path / pkg
        search.cached_search(search.get_workload("edgenext-reduced"),
                             workload="edgenext-reduced", cache_dir=d)
    codes = {}
    for pkg, d in dirs.items():
        art, = d.glob("edgenext-reduced-*.json")
        clean = _run_cli(pkg, str(art), "--json", cwd=tmp_path)
        doc = json.loads(art.read_text())
        doc["cost"]["energy_j"] *= 0.5
        art.write_text(json.dumps(doc))
        tampered = _run_cli(pkg, "--cache-dir", str(d), cwd=tmp_path)
        none = _run_cli(pkg, cwd=tmp_path)
        codes[pkg] = (clean.returncode, tampered.returncode, none.returncode)
        assert json.loads(clean.stdout)["ok"] is True
        assert "check,cost.edp_identity," in tampered.stdout
    assert codes["repro_torch"] == codes["repro"] == (0, 1, 2)


# ---------------------------------------------------------------------------
# the claim-lock protocol: ports of the reference's tests/test_check_races.py
# ---------------------------------------------------------------------------


def _dead_pid() -> int:
    """A pid no process has: that of a child that has exited."""
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    return child.pid


def _plant_stale_lock(path, *, pid=None, age_s=1e6):
    """The claim lock a killed writer leaves: ``<path>.lock`` holding a
    pid, its mtime set ``age_s`` seconds back."""
    lock = Path(f"{path}.lock")
    lock.write_text(str(_dead_pid() if pid is None else pid))
    old = time.time() - age_s
    os.utime(lock, (old, old))
    return lock


def _results(rs):
    return [(r.protocol, r.n, r.max_crashes, r.states, r.terminals,
             sorted(r.outcomes), [(v.kind, v.trace) for v in r.violations])
            for r in rs]


@functools.lru_cache(maxsize=None)
def _protocol():
    return verify_protocol(max_n=3)


def test_explorer_results_equal_the_reference():
    assert _results(_protocol()) == _results(jraces.verify_protocol(max_n=3))
    for kw in (dict(n=2, protocol="legacy"),
               dict(n=2, protocol="legacy", planted_stamp="dead"),
               dict(n=2, planted_stamp="dead", artifact=True)):
        assert _results([explore(**kw)]) == _results([jraces.explore(**kw)])


def test_flock_protocol_exhaustively_safe():
    """Every interleaving of N=2..3 processes (plus crashes, plus a
    pre-planted dead claimant stamp) keeps the invariants: at most one
    store, at most one claim, no foreign unlink, no lost artifact, no
    leaked lock."""
    results = _protocol()
    assert len(results) == 10
    for r in results:
        assert r.ok, (r.n, r.max_crashes, [v.kind for v in r.violations])
        assert r.states > 0 and r.terminals > 0


def test_flock_fault_free_runs_store_exactly_once():
    for planted in (None, "dead"):
        r = explore(2, planted_stamp=planted)
        fault_free = {o for o in r.outcomes if o[2] == 0}
        assert fault_free == {(1, True, 0)}


def test_flock_crashed_runs_never_double_store():
    r = explore(3, max_crashes=2)
    assert r.ok
    assert all(stores <= 1 for stores, _, _ in r.outcomes)


def test_legacy_protocol_races_are_found():
    """The explorer's teeth: the older create/stamp/unlink scheme shows
    the takeover-unlink ABA, the double claim that follows, and the
    late-claim double store, all within N=2 and no crashes."""
    r = explore(2, protocol="legacy")
    kinds = {v.kind for v in r.violations}
    assert {"foreign_unlink", "double_claim", "multi_store"} <= kinds
    for v in r.violations:
        assert v.trace, "each violation carries a replayable trace"


def test_legacy_planted_stamp_races():
    r = explore(2, protocol="legacy", planted_stamp="dead")
    assert {"double_claim", "multi_store"} & \
        {v.kind for v in r.violations}


def test_claim_is_exclusive_and_released(tmp_path):
    path = tmp_path / "wl-key.json"
    assert _claim_store(path) is True
    # flock conflicts apply across open file descriptions, so a second
    # claim in the same process models a rival process exactly
    assert _claim_store(path) is False
    _release_store(path)
    assert not (tmp_path / "wl-key.json.lock").exists()
    assert _claim_store(path) is True
    _release_store(path)


def test_dead_stamp_taken_over_once(tmp_path):
    """One dead claimant's stamp yields exactly one takeover: the second
    contender is denied by the flock and does not take over the first's
    fresh claim."""
    path = tmp_path / "wl-key.json"
    _plant_stale_lock(path)
    with obs.tracing() as tr:
        assert _claim_store(path) is True
        assert _claim_store(path) is False
    assert tr.counters.get("cache.lock_takeover") == 1
    _release_store(path)
    assert not (tmp_path / "wl-key.json.lock").exists()


def test_live_fresh_stamp_not_taken_over(tmp_path):
    path = tmp_path / "wl-key.json"
    _plant_stale_lock(path, pid=os.getpid(), age_s=0.0)
    with obs.tracing() as tr:
        assert _claim_store(path) is False
    assert not tr.counters.get("cache.lock_takeover")
    assert (tmp_path / "wl-key.json.lock").exists()   # left intact


def test_late_claim_skips_store_on_valid_artifact(tmp_path):
    """Exactly-one-store is unconditional: a claimant that wins the lock
    after a valid artifact already landed does not store again; the
    artifact stays byte-identical."""
    first = cached_search(_TINY, workload="tiny", cache_dir=tmp_path)
    art, = tmp_path.glob("tiny-hopper-*.json")
    before = art.read_bytes()
    with obs.tracing() as tr:
        again = cached_search(_TINY, workload="tiny",
                              cache_dir=tmp_path, replay=False)
    assert tr.counters.get("cache.store_skipped") == 1
    assert not tr.counters.get("cache.store")
    assert art.read_bytes() == before
    assert dataclasses.asdict(again) == dataclasses.asdict(first)


def test_claim_repairs_corrupt_artifact(tmp_path):
    """The late-claim store skip does not shadow repair: a corrupt
    on-disk artifact is stored again under the claim."""
    cached_search(_TINY, workload="tiny", cache_dir=tmp_path)
    art, = tmp_path.glob("tiny-hopper-*.json")
    art.write_text(art.read_text()[:40])               # truncate
    with obs.tracing() as tr:
        cached_search(_TINY, workload="tiny", cache_dir=tmp_path)
    assert tr.counters.get("cache.corrupt") == 1
    assert tr.counters.get("cache.store") == 1
    json.loads(art.read_text())                        # valid again
