"""The port's fault injection and graceful-degradation ladder against the
JAX package's, on the CPU.

Ports of the reference's ``tests/test_chaos.py``: under every fault class a
lookup still serves, fault-free runs stay bit-identical, and the claim-lock
hardening holds (stale takeover, the ``stale_s`` keyword and the
``REPRO_CLAIM_STALE_S`` override restored in ``repro_torch.search.cache``,
no leak when the search raises).  Then parity: one plan and seed give the
same per-request outcomes and the same ``serve.*`` / ``cache.*`` counters
in both packages, which shows that the port's chaos sabotages the files its
store really reads (``artifact_name``).
"""
import dataclasses
import json
import os

import pytest

import repro.obs as jobs
import repro.serve as jserve
import repro_torch.serve as tserve
from repro_torch import obs
from repro_torch.search import get_workload
from repro_torch.search.cache import (SEARCH_VERSION, cached_search,
                                      claim_stale_s)
from repro_torch.serve import (ChaosMonkey, ChaosPlan, DeadlineExceeded,
                               InjectedFault, ServeStore, chaos_session,
                               heuristic_schedule)
from repro_torch.serve.chaos import (artifact_path, plant_stale_lock,
                                     set_artifact_version, truncate_artifact)

_ARCH = "edgenext-reduced"


def _store(tmp_path, **kw):
    kw.setdefault("retry_backoff_s", 0.001)
    return ServeStore(tmp_path / "cache", **kw)


# ---------------------------------------------------------------------------
# fault-free: bit-identical, zero-overhead chaos plumbing
# ---------------------------------------------------------------------------


def test_fault_free_run_is_bit_identical(tmp_path):
    """An all-zeros plan (chaos installed but never firing) produces
    byte-identical artifacts and identical lookup outcomes vs no chaos
    at all — the injection hook must cost nothing when quiet."""
    plain = _store(tmp_path / "a")
    plain.warm([_ARCH], batches=(1, 2))
    with ChaosMonkey(ChaosPlan(seed=0)).active():
        quiet = _store(tmp_path / "b")
        quiet.warm([_ARCH], batches=(1, 2))
        res = quiet.request(_ARCH, 2)
    assert res.outcome == "mem" and not res.degraded
    for b in (1, 2):
        pa = artifact_path(plain, _ARCH, b)
        pb = artifact_path(quiet, _ARCH, b)
        assert pa.read_bytes() == pb.read_bytes()


def test_chaos_session_is_seed_deterministic(tmp_path):
    plan = ChaosPlan(seed=11, worker_crash=0.4, corrupt_artifact=0.3,
                     stale_lock=0.3, version_mismatch=0.3,
                     slow_search=0.3, slow_s=0.0)
    reps = []
    for sub in ("a", "b"):
        store = _store(tmp_path / sub)
        store.warm([_ARCH], batches=(1, 2))
        reps.append(chaos_session(store, _ARCH, n_requests=16,
                                  plan=plan, batches=(1, 2)))
    assert reps[0].events == reps[1].events
    assert reps[0].faults == reps[1].faults
    assert reps[0].all_served and reps[1].all_served


def test_chaos_plan_parse():
    p = ChaosPlan.parse("worker_crash=0.3,stale_lock=0.2", seed=5)
    assert p.worker_crash == 0.3 and p.stale_lock == 0.2
    assert p.seed == 5 and p.corrupt_artifact == 0.0
    assert ChaosPlan.parse("all=0.25").slow_search == 0.25
    assert ChaosPlan.parse("all=0.1,crash_attempts=3").crash_attempts == 3
    with pytest.raises(ValueError):
        ChaosPlan.parse("no_such_fault=1")


# ---------------------------------------------------------------------------
# fault class: corrupt / truncated artifact (satellite)
# ---------------------------------------------------------------------------


def test_corrupt_artifact_researches_and_roundtrips(tmp_path):
    """Satellite: a truncated artifact re-searches (never crashes),
    counts exactly one ``cache.corrupt``, and the repaired artifact
    round-trips on the next cold lookup."""
    store = _store(tmp_path)
    store.warm([_ARCH], batches=(1,))
    path = artifact_path(store, _ARCH, 1)
    good = path.read_bytes()
    truncate_artifact(path)
    store.evict(_ARCH, 1)
    with obs.tracing() as tr:
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched" and not res.degraded
    assert tr.counters["cache.corrupt"] == 1
    assert tr.counters["cache.miss"] == 1
    assert tr.counters["cache.store"] == 1
    # repaired: byte-identical to the pre-sabotage artifact...
    assert path.read_bytes() == good
    # ...and a fresh store replays it straight off disk
    fresh = _store(tmp_path, retry_attempts=1)
    with obs.tracing() as tr2:
        res2 = fresh.request(_ARCH, 1)
    assert res2.outcome == "disk"
    assert tr2.counters.get("cache.corrupt", 0) == 0
    assert res2.schedule.cost == res.schedule.cost


# ---------------------------------------------------------------------------
# fault class: version-mismatch artifact
# ---------------------------------------------------------------------------


def test_version_mismatch_rejects_and_rewrites(tmp_path):
    store = _store(tmp_path)
    store.warm([_ARCH], batches=(1,))
    path = artifact_path(store, _ARCH, 1)
    set_artifact_version(path, version=1)
    store.evict(_ARCH, 1)
    with obs.tracing() as tr:
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched" and not res.degraded
    assert tr.counters["cache.version_reject"] == 1
    assert tr.counters.get("cache.corrupt", 0) == 0
    assert json.loads(path.read_text())["version"] == SEARCH_VERSION


# ---------------------------------------------------------------------------
# fault class: stale claim locks (+ the staleness-override satellite)
# ---------------------------------------------------------------------------


def test_stale_lock_dead_pid_taken_over(tmp_path):
    """A claim lock left by a dead writer is broken, the search stores,
    and no lock file survives."""
    store = _store(tmp_path)
    path = store.artifact_path(_ARCH, 1)
    plant_stale_lock(path)                        # dead pid
    with obs.tracing() as tr:
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched"
    assert tr.counters["cache.lock_takeover"] == 1
    assert tr.counters["cache.store"] == 1
    assert not os.path.exists(f"{path}.lock")
    assert path.exists()


def test_live_lock_within_staleness_skips_store(tmp_path):
    """A *live* claim inside the staleness window is honored: the
    search still serves, the store is skipped (the live writer owns
    it), and the lock is left alone."""
    store = _store(tmp_path)
    path = store.artifact_path(_ARCH, 1)
    plant_stale_lock(path, pid=os.getpid(), age_s=0.0)   # live + fresh
    with obs.tracing() as tr:
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched"
    assert tr.counters["cache.store_skipped"] == 1
    assert tr.counters.get("cache.lock_takeover", 0) == 0
    assert os.path.exists(f"{path}.lock")


def test_stale_s_keyword_overrides_window(tmp_path):
    """Satellite: a live pid aged past a per-store ``stale_s`` is taken
    over — the serving loop's tight window beats the DSE default."""
    store = _store(tmp_path, stale_s=0.5)
    path = store.artifact_path(_ARCH, 1)
    plant_stale_lock(path, pid=os.getpid(), age_s=60.0)  # live but old
    with obs.tracing() as tr:
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched"
    assert tr.counters["cache.lock_takeover"] == 1
    assert tr.counters["cache.store"] == 1


def test_claim_stale_env_override(monkeypatch):
    """Satellite: resolution order is keyword > env > default."""
    monkeypatch.delenv("REPRO_CLAIM_STALE_S", raising=False)
    default = claim_stale_s()
    assert default == 120.0
    monkeypatch.setenv("REPRO_CLAIM_STALE_S", "7.5")
    assert claim_stale_s() == 7.5
    assert claim_stale_s(3.0) == 3.0              # keyword wins
    monkeypatch.setenv("REPRO_CLAIM_STALE_S", "not-a-number")
    assert claim_stale_s() == 120.0               # bad env ignored


def test_no_lock_leak_when_search_raises(tmp_path, monkeypatch):
    """Satellite regression: the claimant raising mid-search must
    release its claim (finally), never wedge the key for the staleness
    window."""
    from repro_torch.search import auto as auto_mod
    layers = get_workload(_ARCH)

    def boom(*a, **k):
        raise RuntimeError("search died mid-DP")

    monkeypatch.setattr(auto_mod, "auto_schedule", boom)
    with pytest.raises(RuntimeError, match="mid-DP"):
        cached_search(layers, workload=_ARCH, cache_dir=tmp_path)
    assert not list(tmp_path.glob("*.lock")), "claim lock leaked"
    # the key is immediately claimable again
    monkeypatch.undo()
    with obs.tracing() as tr:
        cached_search(layers, workload=_ARCH, cache_dir=tmp_path)
    assert tr.counters["cache.store"] == 1
    assert tr.counters.get("cache.lock_takeover", 0) == 0


# ---------------------------------------------------------------------------
# fault class: crashed search workers -> the retry envelope
# ---------------------------------------------------------------------------


def test_worker_crash_recovered_by_retry(tmp_path):
    """One crashing attempt inside a 3-attempt envelope: the request
    still comes back ``searched`` and the recovery is counted."""
    store = _store(tmp_path, retry_attempts=3)
    monkey = ChaosMonkey(ChaosPlan(seed=0, crash_attempts=1))
    with obs.tracing() as tr, monkey.active():
        monkey.arm_search_faults(crash=True, slow=False)
        res = store.request(_ARCH, 1)
    assert res.outcome == "searched" and not res.degraded
    assert res.attempts == 2
    assert tr.counters["serve.retry.attempt"] == 2
    assert tr.counters["serve.retry.failure"] == 1
    assert tr.counters["serve.retry.recovered"] == 1
    assert tr.counters["serve.chaos.worker_crash"] == 1


def test_crash_exhausts_retries_degrades_to_nearest_batch(tmp_path):
    """Every attempt crashes: rung 4 serves the nearest co-searched
    batch level with linearly rescaled cost, flagged degraded."""
    store = _store(tmp_path, retry_attempts=2)
    store.warm([_ARCH], batches=(1,))
    base = store.request(_ARCH, 1).schedule
    monkey = ChaosMonkey(ChaosPlan(seed=0, crash_attempts=99))
    with obs.tracing() as tr, monkey.active():
        monkey.arm_search_faults(crash=True, slow=False)
        res = store.request(_ARCH, 2)
    assert res.outcome == "nearest_batch" and res.degraded
    assert "InjectedFault" in res.error
    assert getattr(res.schedule, "degraded", None) == "nearest_batch"
    # b=2 off the b=1 neighbor: latency/energy x2, edp x4, fps /2
    c, c0 = res.schedule.cost, base.cost
    assert c["latency_s"] == pytest.approx(2 * c0["latency_s"])
    assert c["energy_j"] == pytest.approx(2 * c0["energy_j"])
    assert c["edp"] == pytest.approx(4 * c0["edp"])
    assert c["fps"] == pytest.approx(c0["fps"] / 2)
    assert res.schedule.workload == f"{_ARCH}-b2"
    assert tr.counters["serve.degrade.search_failed"] == 1
    assert tr.counters["serve.degrade.nearest_batch"] == 1
    # the degraded answer never shadows the real tiers: with the fault
    # cleared, the next request cold-searches the true schedule
    res2 = store.request(_ARCH, 2)
    assert res2.outcome == "searched" and not res2.degraded


def test_crash_with_empty_store_serves_heuristic(tmp_path):
    """No neighbor to degrade onto: rung 5's untiled heuristic serves —
    a complete, costed, strictly-worse schedule, never None."""
    store = _store(tmp_path, retry_attempts=1)
    monkey = ChaosMonkey(ChaosPlan(seed=0, crash_attempts=99))
    with obs.tracing() as tr, monkey.active():
        monkey.arm_search_faults(crash=True, slow=False)
        res = store.request(_ARCH, 1)
    assert res.outcome == "heuristic" and res.degraded
    sched = res.schedule
    assert sched is not None
    assert getattr(sched, "degraded", None) == "heuristic"
    assert all(len(g) == 1 for g in sched.groups)       # no fusion
    assert sched.cost["latency_s"] > 0
    assert tr.counters["serve.degrade.heuristic"] == 1
    # it IS worse than the searched optimum (sanity on the flag)
    searched = cached_search(get_workload(_ARCH),
                             cache_dir=tmp_path / "cache")
    assert sched.cost["edp"] >= searched.cost["edp"]


def test_heuristic_schedule_direct():
    layers = get_workload(_ARCH)
    sched = heuristic_schedule(layers, workload=_ARCH)
    assert len(sched.groups) == len(layers)
    assert sched.edges == () and sched.lowered == {}
    assert sched.cost["fps"] == pytest.approx(
        1.0 / sched.cost["latency_s"])


# ---------------------------------------------------------------------------
# fault class: slow searches -> the deadline
# ---------------------------------------------------------------------------


def test_slow_search_blows_deadline_and_degrades(tmp_path):
    """A slow search past the request deadline: the envelope raises
    ``DeadlineExceeded`` internally, counts it, and the ladder serves a
    degraded answer instead of stalling."""
    store = _store(tmp_path, retry_attempts=3, search_deadline_s=0.02)
    store.warm([_ARCH], batches=(1,))
    monkey = ChaosMonkey(ChaosPlan(seed=0, slow_s=0.05,
                                   crash_attempts=99))
    with obs.tracing() as tr, monkey.active():
        monkey.arm_search_faults(crash=True, slow=True)
        res = store.request(_ARCH, 2)
    assert res.degraded
    assert "DeadlineExceeded" in res.error
    assert tr.counters["serve.retry.deadline_exceeded"] == 1
    assert tr.counters["serve.chaos.slow_search"] == 1


def test_per_request_deadline_overrides_store_default(tmp_path):
    store = _store(tmp_path, retry_attempts=1, search_deadline_s=None)
    monkey = ChaosMonkey(ChaosPlan(seed=0, slow_s=0.05))
    with monkey.active():
        monkey.arm_search_faults(crash=False, slow=True)
        # a 1ms budget is spent by the 50ms injected sleep: after the
        # slow first attempt the envelope refuses a second and degrades
        store2 = ServeStore(store.cache_dir, retry_attempts=2,
                            retry_backoff_s=0.001)
        monkey.arm_search_faults(crash=True, slow=True)
        res = store2.request(_ARCH, 1, deadline_s=0.001)
    assert res.outcome == "heuristic" and res.degraded


# ---------------------------------------------------------------------------
# the end-to-end chaos session + warm-pool crash tolerance
# ---------------------------------------------------------------------------


def test_chaos_session_every_fault_class_still_serves(tmp_path):
    """The acceptance criterion: a session arming every fault class at
    high probability serves all requests, with the degradation paths
    recorded in ``serve.degrade.*`` / ``serve.retry.*``."""
    store = _store(tmp_path, retry_attempts=2)
    store.warm([_ARCH], batches=(1, 2))
    plan = ChaosPlan(seed=13, worker_crash=0.5, corrupt_artifact=0.4,
                     stale_lock=0.4, version_mismatch=0.4,
                     slow_search=0.4, slow_s=0.0, crash_attempts=2)
    with obs.tracing() as tr:
        rep = chaos_session(store, _ARCH, n_requests=20, plan=plan,
                            batches=(1, 2))
    assert rep.all_served, f"lost {rep.requests - rep.served} requests"
    assert sum(rep.faults.values()) > 0
    # every armed fault class actually fired somewhere in the session
    assert all(rep.faults[f] > 0 for f in rep.faults)
    assert tr.counters["serve.chaos.requests"] == 20
    assert tr.counters["serve.chaos.served"] == 20
    # crash_attempts == retry_attempts: crashes exhaust the envelope,
    # so the ladder (not just the retry) must have carried some load
    assert tr.counters.get("serve.degrade.search_failed", 0) > 0
    assert tr.counters.get("serve.degrade.nearest_batch", 0) > 0
    assert tr.counters.get("serve.retry.failure", 0) > 0


def test_warm_pool_tolerates_crashed_workers(tmp_path):
    """Every pool worker crashes: warm still completes (the parent's
    serial faulting pass recovers each grid point) and counts the
    failures."""
    store = _store(tmp_path)
    monkey = ChaosMonkey(ChaosPlan(seed=0, worker_crash=1.0))
    with obs.tracing() as tr, monkey.active():
        rep = store.warm([_ARCH], batches=(1, 2), jobs=2)
    assert rep.worker_failed == 2
    assert tr.counters["serve.warm.worker_failed"] == 2
    assert rep.searched == 2                 # recovered serially
    assert store.resident(_ARCH, 1) and store.resident(_ARCH, 2)


def test_injected_fault_survives_pickling():
    import pickle
    e = pickle.loads(pickle.dumps(InjectedFault("worker_crash")))
    assert isinstance(e, InjectedFault)
    assert e.fault == "worker_crash"
    assert isinstance(e, RuntimeError)
    assert issubclass(DeadlineExceeded, RuntimeError)


# ---------------------------------------------------------------------------
# parity with the reference: one plan, one seed, both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["all=0.3", "all=0.3,crash_attempts=3"],
                         ids=["retried", "degraded"])
def test_chaos_session_equals_the_reference(tmp_path, spec):
    """The same session in both packages: the same faults on the same
    requests, the same rung answering each, the same counters.  With
    crashes that outlast the three search attempts, rungs 4 and 5 serve."""
    got = {}
    for pkg, serve, tracing in (("repro", jserve, jobs.tracing),
                                ("repro_torch", tserve, obs.tracing)):
        store = serve.ServeStore(tmp_path / pkg, retry_backoff_s=0.001)
        store.warm(["edgenext-s"], batches=(1, 4))
        with tracing() as tr:
            rep = serve.chaos_session(
                store, "edgenext-s", n_requests=24, batches=(1, 4),
                plan=serve.ChaosPlan.parse(spec, seed=0))
        got[pkg] = dict(
            events=[dataclasses.asdict(e) for e in rep.events],
            faults=rep.faults, outcomes=rep.outcomes, served=rep.served,
            degraded=rep.degraded,
            counters={k: v for k, v in tr.counters.items()
                      if k.startswith(("serve.", "cache."))})
    assert got["repro_torch"] == got["repro"]
    t = got["repro_torch"]
    assert t["served"] == 24
    assert t["counters"]["serve.chaos.corrupt_artifact"] >= 1
    assert t["counters"]["cache.corrupt"] >= 1
    assert t["counters"]["cache.version_reject"] >= 1
    assert t["counters"]["cache.lock_takeover"] >= 1
    if spec.endswith("crash_attempts=3"):
        assert t["counters"]["serve.degrade.nearest_batch"] >= 1
        assert t["counters"]["serve.degrade.heuristic"] >= 1
    else:
        assert t["degraded"] == 0
