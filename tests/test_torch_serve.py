"""The port's serving layer against the JAX package's, on the CPU.

``repro_torch.serve`` is a copy of ``repro.serve`` whose artifacts go
through ``repro_torch.search.cache.artifact_name``.  Here: the ports of the
reference's ``tests/test_serve.py`` (all but the data-parallel fan-out,
which needs ``runtime.pipeline``) and ``tests/test_serve_loop.py``; then
parity, each result computed by both packages from the same inputs: the
co-searched batch curves, the policy's picks, the loop reports, a warmed
store's schedules (every field but ``lowered``) and the CLI's output (but
the store's path, the wall-clock rows and the ``lowered=`` count); a store
on a directory the reference warmed replays none of its files; and the
package imports no JAX.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

import repro.serve as jserve
from repro.core.costmodel import HWSpec as JHWSpec
from repro.serve.loop import LOOP_RATES as J_LOOP_RATES
from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.workload import (Layer, edgenext_serving_workload,
                                       fastvit_serving_workload,
                                       mobilevit_serving_workload,
                                       vit_workload, with_batch)
from repro_torch.search import get_workload, parse_workload
from repro_torch.search.cache import (SEARCH_VERSION, _remap_layer_names,
                                      cached_search)
from repro_torch.serve import (BATCH_LEVELS, BatchPoint, ServePolicy,
                               ServeStore, canonical_name, co_search,
                               distinct_batches, model_fill_wait, pick_batch,
                               poisson_arrivals, rate_table, run_loop,
                               simulate, trace_arrivals)
from repro_torch.serve.loop import LOOP_RATES

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "")}
# the reference's subprocesses: without the override JAX probes for a TPU
J_ENV = dict(ENV, JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# batch as a first-class mapspace dim (ports of tests/test_serve.py)
# ---------------------------------------------------------------------------


def test_with_batch_scales_b_only():
    wl = get_workload("edgenext-reduced")
    b4 = with_batch(wl, 4)
    assert [l.name for l in b4] == [l.name for l in wl]
    for a, b in zip(wl, b4):
        assert b.b == 4 * a.b
        assert dataclasses.replace(b, b=a.b) == a


def test_with_batch_identity_and_validation():
    wl = get_workload("edgenext-reduced")
    same = with_batch(wl, 1)
    assert same == wl and same is not wl
    with pytest.raises(ValueError):
        with_batch(wl, 0)


def test_with_batch_matches_serving_builders():
    """The generalized transform reproduces every hand-written -b4
    serving builder layer-for-layer (names included)."""
    for name, builder in (("edgenext-s", edgenext_serving_workload),
                          ("fastvit-s", fastvit_serving_workload),
                          ("mobilevit-s", mobilevit_serving_workload)):
        assert with_batch(get_workload(name), 4) == builder(batch=4)
        assert get_workload(f"{name}-b4") == builder(batch=4)


def test_registry_resolves_any_batch_suffix():
    assert get_workload("vit-tiny-b16") == with_batch(vit_workload(), 16)
    assert parse_workload("edgenext-s-b64") == ("edgenext-s", 64)
    assert parse_workload("edgenext-s") == ("edgenext-s", 1)
    # 'b0' is an architecture suffix, not a batch level
    assert parse_workload("efficientvit-b0") == ("efficientvit-b0", 1)
    with pytest.raises(KeyError):
        get_workload("no-such-arch-b4")


def test_canonical_name_composes_batches():
    assert canonical_name("edgenext-s", 4) == "edgenext-s-b4"
    assert canonical_name("edgenext-s", 1) == "edgenext-s"
    assert canonical_name("edgenext-s-b4", 4) == "edgenext-s-b16"


# ---------------------------------------------------------------------------
# cache correctness: atomic writes, duplicate names
# ---------------------------------------------------------------------------

_TINY = [Layer("l0", "pwconv", k=8, c=8, ox=4, oy=4),
         Layer("l1", "dwconv", c=8, ox=4, oy=4, fx=3, fy=3)]


def test_save_schedule_atomic_under_kill(tmp_path):
    """SIGKILL a writer loop at arbitrary instants: the artifact is
    always either absent or complete valid JSON, and the temp files a
    crash can leave behind never match the ``*.json`` loader glob."""
    art = tmp_path / "wl-abc.json"
    child = textwrap.dedent(f"""
        import dataclasses, sys
        from pathlib import Path
        from repro_torch.search.cache import save_schedule

        @dataclasses.dataclass
        class Doc:
            version: int
            payload: str

        doc = Doc(version=1, payload="x" * 500_000)
        path = Path({str(art)!r})
        print("ready", flush=True)
        while True:
            save_schedule(doc, path)
    """)
    for delay in (0.0, 0.01, 0.05):
        p = subprocess.Popen([sys.executable, "-c", child], env=ENV,
                             cwd=ROOT, stdout=subprocess.PIPE, text=True)
        try:
            assert p.stdout.readline().strip() == "ready"
            time.sleep(delay)
        finally:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=30)
        if art.exists():
            doc = json.loads(art.read_text())      # complete, parseable
            assert len(doc["payload"]) == 500_000
        leftovers = list(tmp_path.glob("*.json"))
        assert leftovers in ([], [art]), leftovers


def test_remap_rejects_duplicate_layer_names(tmp_path):
    """An artifact whose chain holds two identically named layers cannot
    be positionally remapped onto distinct request names; ``cached_search``
    then treats the artifact as corrupt and re-searches."""
    hw = HWSpec()
    twin = [dataclasses.replace(_TINY[0], name="n0"),
            dataclasses.replace(_TINY[0], name="n1")]    # equal signatures
    sched = cached_search(twin, hw, workload="twin", cache_dir=tmp_path)

    dup = dataclasses.replace(
        sched, groups=tuple(("n0",) for _ in sched.groups))
    assert _remap_layer_names(dup, twin) is None
    collapse = [dataclasses.replace(l, name="same") for l in twin]
    assert _remap_layer_names(sched, collapse) is None

    art, = tmp_path.glob("twin-hopper-*.json")
    art.write_text(art.read_text().replace('"n1"', '"n0"'))
    with obs.tracing() as tr:
        again = cached_search(twin, hw, workload="twin",
                              cache_dir=tmp_path)
    assert tr.counters.get("cache.corrupt") == 1
    assert tr.counters.get("cache.miss") == 1
    assert tr.counters.get("cache.store") == 1
    assert not tr.counters.get("cache.hit")
    assert dataclasses.asdict(again) == dataclasses.asdict(sched)


# ---------------------------------------------------------------------------
# the warm store
# ---------------------------------------------------------------------------


def test_store_warm_then_hit_counters(tmp_path):
    store = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        rep = store.warm(["edgenext-reduced"], batches=(1, 2))
    assert rep.entries == ("edgenext-reduced", "edgenext-reduced-b2")
    assert rep.searched == 2 and len(rep.keys) == 2
    assert tr.counters.get("cache.miss") == 2
    assert tr.counters.get("cache.store") == 2
    assert len(store) == 2

    # warm store: every lookup is a memory hit, never the DP
    with obs.tracing() as tr:
        s1 = store.lookup("edgenext-reduced", 1)
        s2 = store.lookup("edgenext-reduced", 2)
    assert tr.counters.get("cache.hit") == 2
    assert tr.counters.get("serve.store.mem_hit") == 2
    assert not tr.counters.get("cache.miss")
    assert s2.cost["latency_s"] > s1.cost["latency_s"]

    # second warm over a superset: only the new grid point searches
    with obs.tracing() as tr:
        rep2 = store.warm(["edgenext-reduced"], batches=(1, 2, 4))
    assert rep2.searched == 1 and len(rep2.entries) == 3


def test_store_disk_tier_and_version_reject(tmp_path):
    hot = ServeStore(tmp_path, HWSpec())
    hot.warm(["edgenext-reduced"], batches=(1,))
    # a fresh store (new process analogue) replays from disk: cache.hit
    # without the memory layer
    cold = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        cold.lookup("edgenext-reduced", 1)
    assert tr.counters.get("cache.hit") == 1
    assert not tr.counters.get("serve.store.mem_hit")
    assert not tr.counters.get("cache.miss")
    # stale engine version: rejected, re-searched, re-stored
    art, = tmp_path.glob("edgenext-reduced-hopper-*.json")
    doc = json.loads(art.read_text())
    doc["version"] = SEARCH_VERSION - 1
    art.write_text(json.dumps(doc))
    stale = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        stale.lookup("edgenext-reduced", 1)
    assert tr.counters.get("cache.version_reject") == 1
    assert tr.counters.get("cache.miss") == 1
    assert tr.counters.get("cache.store") == 1


def test_store_warm_process_pool_folds_counters(tmp_path):
    """The pool is spawned; its workers' counters are folded back and the
    parent replays what they stored."""
    store = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        rep = store.warm(["edgenext-reduced"], batches=(1, 2), jobs=2)
    assert rep.searched == 2
    assert tr.counters.get("cache.miss") == 2
    assert tr.counters.get("cache.store") == 2
    assert tr.counters.get("cache.hit") == 2    # parent replays artifacts
    assert store.resident("edgenext-reduced", 2)


def test_store_dedupes_grid_aliases(tmp_path):
    """'wl' at batch 2 and 'wl-b2' at batch 1 are one content key:
    warmed, searched, and stored exactly once."""
    store = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        rep = store.warm(["edgenext-reduced", "edgenext-reduced-b2"],
                         batches=(1, 2))
    assert len(rep.entries) == 3               # b1, b2, b4
    assert tr.counters.get("cache.store") == 3
    assert len(list(tmp_path.glob("*-hopper-*.json"))) == 3


# ---------------------------------------------------------------------------
# the batching policy
# ---------------------------------------------------------------------------


def _linear_points(lat1: float = 0.05):
    """Synthetic co-searched curve with latency linear in batch (what
    the compute-bound cost model actually produces)."""
    return [BatchPoint(workload=f"wl-b{b}", batch=b,
                       latency_s=lat1 * b, energy_j=1.0 * b,
                       edp=lat1 * b * b, key=f"k{b}")
            for b in (1, 4, 16, 64)]


def test_policy_non_degenerate_across_rates():
    pts = _linear_points()
    picks = rate_table(pts, (2.0, 15.0, 60.0),
                       dispatch_s=0.020, devices=4)
    assert [p.point.batch for p in picks] == [1, 4, 16]
    assert distinct_batches(picks) >= 2
    assert all(not p.saturated for p in picks)
    assert all(p.sustained_rps >= p.rate_rps for p in picks)


def test_policy_shards_over_cosearched_levels_only():
    pts = _linear_points()
    pick = pick_batch(pts, 60.0, dispatch_s=0.020, devices=4)
    assert (pick.point.batch, pick.devices) == (16, 4)
    assert pick.shard_point.batch == 4
    # devices=3 cannot shard any level: the fan-out degrades to 1
    pick3 = pick_batch(pts, 10.0, dispatch_s=0.020, devices=3)
    assert pick3.devices == 1
    assert pick3.shard_point == pick3.point


def test_policy_single_device_low_rate_prefers_small_batch():
    pts = _linear_points()
    pick = pick_batch(pts, 0.5, dispatch_s=0.001, devices=1)
    assert pick.point.batch == 1


def test_policy_saturated_falls_back_to_max_throughput():
    pts = _linear_points()
    pick = pick_batch(pts, 1e6, dispatch_s=0.020, devices=1)
    assert pick.saturated
    best = max(pts, key=lambda p: p.batch / (0.020 + p.latency_s))
    assert pick.point.batch == best.batch
    with pytest.raises(ValueError):
        pick_batch([], 1.0)


@pytest.mark.slow
def test_serve_cli_warm_then_hit(tmp_path):
    """Warm in one process, serve the lookup from another: the request
    replays the artifact (cache.hit) and never re-searches."""
    base = ["--arch", "edgenext-reduced", "--batches", "1,2",
            "--cache-dir", str(tmp_path)]
    run = lambda extra: subprocess.run(
        [sys.executable, "-m", "repro_torch.serve"] + base + extra,
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=600)
    warm = run(["--warm"])
    assert warm.returncode == 0, warm.stderr[-3000:]
    assert "serve.warm.cache.store,2," in warm.stdout
    look = run(["--lookup", "2", "--rates", "2,60", "--devices", "2"])
    assert look.returncode == 0, look.stderr[-3000:]
    assert "serve.cache.hit,1," in look.stdout
    assert "serve.cache.miss,0," in look.stdout
    assert "serve.policy.edgenext-reduced.distinct_batches," \
        in look.stdout


# ---------------------------------------------------------------------------
# the simulated request loop (ports of tests/test_serve_loop.py)
# ---------------------------------------------------------------------------


def _pt(batch, lat):
    return BatchPoint(workload=f"w-b{batch}", batch=batch,
                      latency_s=lat, energy_j=1.0, edp=lat, key="k")


_CURVE = [_pt(1, 0.010), _pt(4, 0.036), _pt(16, 0.120)]


def test_policy_zero_rate_picks_batch_one():
    pick = pick_batch(_CURVE, 0.0)
    assert pick.point.batch == 1
    assert not pick.saturated
    assert pick_batch(_CURVE, -1.0).point.batch == 1


def test_policy_zero_rate_marks_larger_batches_infeasible():
    pol = ServePolicy(dispatch_s=0.020)
    cands = {c.point.batch: c for c in pol.evaluate(_CURVE, 0.0)}
    assert not cands[1].saturated
    assert cands[1].expected_latency_s == pytest.approx(0.030)
    for b in (4, 16):
        assert cands[b].saturated
        assert cands[b].expected_latency_s == float("inf")


def test_policy_zero_rate_without_batch_one_point():
    assert pick_batch(_CURVE[1:], 0.0).point.batch == 4


def test_policy_rate_at_exact_ceiling_is_feasible():
    pol = ServePolicy(dispatch_s=0.020)
    ceiling = 1.0 / 0.030
    cands = {c.point.batch: c for c in pol.evaluate(_CURVE, ceiling)}
    assert cands[1].sustained_rps == pytest.approx(ceiling)
    assert not cands[1].saturated
    above = {c.point.batch: c
             for c in pol.evaluate(_CURVE, ceiling * (1 + 1e-9))}
    assert above[1].saturated


def test_poisson_arrivals_deterministic_and_calibrated():
    a = poisson_arrivals(4000, 15.0, seed=3)
    b = poisson_arrivals(4000, 15.0, seed=3)
    assert a == b
    assert a != poisson_arrivals(4000, 15.0, seed=4)
    assert all(x < y for x, y in zip(a, a[1:]))
    mean_gap = a[-1] / len(a)
    assert mean_gap == pytest.approx(1 / 15.0, rel=0.05)
    with pytest.raises(ValueError):
        poisson_arrivals(10, 0.0)


def test_trace_arrivals_accumulates():
    assert trace_arrivals([0.5, 0.25, 0.25]) == [0.5, 0.75, 1.0]


def test_model_fill_wait_closed_form():
    assert model_fill_wait(1, 15.0) == 0.0
    assert model_fill_wait(4, 2.0) == pytest.approx(0.75)
    assert model_fill_wait(4, 0.0) == float("inf")


def test_simulate_hand_trace_fill_and_queue():
    rep = simulate([1.0, 2.0, 3.0, 4.0], batch=2, service_s=0.5,
                   rate_rps=1.0)
    assert rep.batches == 2 and rep.partial_batches == 0
    waits = [r.fill_wait_s for r in rep.records]
    assert waits == [1.0, 0.0, 1.0, 0.0]
    assert rep.fill_wait_mean_s == pytest.approx(0.5)
    assert rep.model_fill_wait_s == pytest.approx(0.5)
    assert rep.fillwait_err == pytest.approx(0.0)
    assert rep.queue_wait_mean_s == 0.0
    assert rep.makespan_s == pytest.approx(4.5)


def test_simulate_queueing_behind_busy_server():
    rep = simulate([1.0, 2.0, 3.0, 4.0], batch=2, service_s=3.0,
                   rate_rps=1.0)
    b = rep.records[2]
    assert b.dispatched_s == pytest.approx(4.0)
    assert b.started_s == pytest.approx(5.0)
    assert b.queue_wait_s == pytest.approx(1.0)


def test_simulate_fill_timer_flushes_partials():
    rep = simulate([1.0, 10.0], batch=4, service_s=0.1,
                   fill_timeout_s=2.0, rate_rps=1.0)
    assert rep.batches == 2 and rep.partial_batches == 2
    assert rep.records[0].dispatched_s == pytest.approx(3.0)
    assert not rep.records[0].full
    assert rep.records[1].dispatched_s == pytest.approx(12.0)
    assert rep.fill_wait_mean_s == 0.0
    assert rep.deadline_misses == 0


def test_simulate_end_of_stream_flush_without_timer():
    rep = simulate([1.0, 2.0, 3.0], batch=2, service_s=0.1,
                   rate_rps=1.0)
    assert rep.batches == 2 and rep.partial_batches == 1
    assert rep.records[2].dispatched_s == pytest.approx(3.0)


def test_simulate_deadline_misses_counted_requests_still_served():
    rep = simulate([1.0, 1.1], batch=2, service_s=5.0, deadline_s=1.0,
                   rate_rps=10.0)
    assert rep.deadline_misses == 2
    assert rep.requests == 2
    assert all(r.deadline_miss for r in rep.records)


def test_simulate_batch_one_is_exact():
    rep = simulate(poisson_arrivals(500, 15.0, seed=0), batch=1,
                   service_s=0.001, rate_rps=15.0)
    assert rep.fill_wait_mean_s == 0.0
    assert rep.model_fill_wait_s == 0.0
    assert rep.fillwait_err == 0.0
    assert rep.partial_batches == 0


def test_simulate_rejects_bad_batch():
    with pytest.raises(ValueError):
        simulate([1.0], batch=0, service_s=0.1)


def test_fillwait_matches_closed_form_within_tolerance():
    for rate in LOOP_RATES:
        for batch in (4, 16):
            rep = simulate(poisson_arrivals(2000, rate, seed=7),
                           batch=batch, service_s=1e-4, rate_rps=rate)
            assert rep.fillwait_err < 0.10, \
                f"b={batch} λ={rate}: err {rep.fillwait_err:.3f}"


@pytest.mark.slow
def test_fillwait_convergence_sweep():
    for seed in range(5):
        for rate in LOOP_RATES:
            for batch in (2, 4, 16, 64):
                rep = simulate(poisson_arrivals(4000, rate, seed=seed),
                               batch=batch, service_s=1e-4,
                               rate_rps=rate)
                assert rep.fillwait_err < 0.10


def test_run_loop_end_to_end(tmp_path):
    store = ServeStore(tmp_path / "cache")
    with obs.tracing() as tr:
        rep = run_loop(store, "edgenext-reduced", rate_rps=30.0,
                       n_requests=600, seed=1, batch=4, batches=(1, 4),
                       dispatch_s=0.001)
    assert rep.batch == 4 and rep.requests == 600
    assert rep.fillwait_err < 0.10
    assert tr.counters["serve.loop.requests"] == 600
    assert tr.counters["serve.loop.batches"] == rep.batches
    assert tr.gauges["serve.loop.fillwait_err"] == rep.fillwait_err
    assert tr.counters["cache.miss"] == 2
    rep2 = run_loop(store, "edgenext-reduced", rate_rps=30.0,
                    n_requests=600, seed=1, batch=4, batches=(1, 4),
                    dispatch_s=0.001)
    assert rep2.fill_wait_mean_s == rep.fill_wait_mean_s


def test_run_loop_policy_pick_and_deadlines(tmp_path):
    store = ServeStore(tmp_path / "cache")
    rep = run_loop(store, "edgenext-reduced", rate_rps=2.0,
                   n_requests=200, seed=0, batches=(1, 4),
                   dispatch_s=0.001, deadline_s=10.0)
    assert rep.batch == 1
    assert rep.deadline_misses == 0
    assert rep.fillwait_err == 0.0


# ---------------------------------------------------------------------------
# parity with the reference: each result computed by both packages
# ---------------------------------------------------------------------------

SERVED = ("edgenext-s", "rwkv6")


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """Each package's store warmed over ``SERVED`` at every batch level:
    (reference store, its report, port store, its report)."""
    d = tmp_path_factory.mktemp("warmed")
    jstore = jserve.ServeStore(d / "repro", JHWSpec())
    tstore = ServeStore(d / "repro_torch", HWSpec())
    jrep = jstore.warm(SERVED, batches=jserve.BATCH_LEVELS)
    trep = tstore.warm(SERVED, batches=BATCH_LEVELS)
    return jstore, jrep, tstore, trep


def test_warmed_store_schedules_equal_the_reference(warmed):
    jstore, jrep, tstore, trep = warmed
    assert BATCH_LEVELS == jserve.BATCH_LEVELS == (1, 4, 16, 64)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert len(trep.entries) == 8 and trep.searched == 8
    for name in trep.entries:
        t = dataclasses.asdict(tstore.lookup(name))
        j = dataclasses.asdict(jstore.lookup(name))
        t.pop("lowered"), j.pop("lowered")
        assert t == j, name


@pytest.mark.parametrize("workload", SERVED)
def test_co_search_points_equal_the_reference(warmed, workload):
    jstore, _, tstore, _ = warmed
    t = co_search(tstore, workload, batches=BATCH_LEVELS)
    j = jserve.co_search(jstore, workload, batches=jserve.BATCH_LEVELS)
    assert [p.batch for p in t] == list(BATCH_LEVELS)
    assert [dataclasses.asdict(p) for p in t] == \
        [dataclasses.asdict(p) for p in j]
    assert not any(p.degraded for p in t)


@pytest.mark.parametrize("devices", [1, 4])
def test_policy_picks_equal_the_reference(warmed, devices):
    jstore, _, tstore, _ = warmed
    assert LOOP_RATES == J_LOOP_RATES
    for workload in SERVED:
        t = co_search(tstore, workload)
        j = jserve.co_search(jstore, workload)
        tt = rate_table(t, LOOP_RATES, devices=devices)
        jt = jserve.rate_table(j, J_LOOP_RATES, devices=devices)
        assert [dataclasses.asdict(p) for p in tt] == \
            [dataclasses.asdict(p) for p in jt]
        assert distinct_batches(tt) == jserve.distinct_batches(jt)
        for rate in (0.0, *LOOP_RATES, 1e6):
            assert dataclasses.asdict(pick_batch(t, rate, devices=devices)) \
                == dataclasses.asdict(jserve.pick_batch(j, rate,
                                                        devices=devices))


def test_loop_reports_equal_the_reference(warmed):
    jstore, _, tstore, _ = warmed
    for batch, rate, timeout in ((1, 15.0, None), (4, 2.0, 0.5),
                                 (16, 60.0, None)):
        arr = poisson_arrivals(500, rate, seed=3)
        assert arr == jserve.poisson_arrivals(500, rate, seed=3)
        kw = dict(batch=batch, service_s=0.01, dispatch_s=0.002,
                  fill_timeout_s=timeout, deadline_s=0.5, rate_rps=rate)
        assert dataclasses.asdict(simulate(arr, **kw)) == \
            dataclasses.asdict(jserve.simulate(arr, **kw))
    for rate in LOOP_RATES:
        kw = dict(rate_rps=rate, n_requests=400, seed=1, devices=4,
                  deadline_s=1.0)
        t = run_loop(tstore, "edgenext-s", **kw)
        j = jserve.run_loop(jstore, "edgenext-s", **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_a_reference_warmed_directory_replays_none_of_its_files(tmp_path):
    """The reference's artifacts carry TPU launch parameters under the
    same content key: a port store on the same directory searches and
    stores its own ``-hopper-`` files, and leaves the reference's as they
    were."""
    name = "edgenext-reduced"
    jserve.ServeStore(tmp_path, JHWSpec()).warm([name], batches=(1, 2))
    theirs = {p: p.read_bytes() for p in tmp_path.glob("*.json")}
    assert len(theirs) == 2
    store = ServeStore(tmp_path, HWSpec())
    with obs.tracing() as tr:
        res = [store.request(name, b) for b in (1, 2)]
    assert [r.outcome for r in res] == ["searched", "searched"]
    assert not tr.counters.get("cache.hit")
    assert not tr.counters.get("cache.corrupt")
    assert tr.counters.get("cache.miss") == 2
    assert tr.counters.get("cache.store") == 2
    assert {p: p.read_bytes() for p in theirs} == theirs
    mine = sorted(p.name for p in tmp_path.glob("*-hopper-*.json"))
    assert mine == sorted(store.artifact_path(name, b).name for b in (1, 2))
    # a fresh port store on the directory counts none of the reference's
    # files as warm: it replays its own
    rep = ServeStore(tmp_path, HWSpec()).warm([name], batches=(1, 2, 4))
    assert rep.searched == 1


# the CLI, each package's as a command in a process of its own on one
# cache directory, in this order
CLI_ARGS = {
    "warm": ["--warm", "--jobs", "2"],
    "lookup": ["--lookup", "4", "--rates", "2,15,60", "--devices", "4"],
    "loop": ["--loop", "--rates", "2,15,60"],
    "chaos": ["--chaos", "all=0.3", "--requests", "24"],
}


def _cli_chain(module, env, cache_dir):
    out = {}
    for name, args in CLI_ARGS.items():
        r = subprocess.run(
            [sys.executable, "-m", module, "--arch", "edgenext-s",
             "--cache-dir", str(cache_dir), *args],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        out[name] = (r.returncode, r.stdout, r.stderr[-3000:])
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{command: (returncode, stdout, stderr)} of each package's CLI; the
    two chains run side by side."""
    d = tmp_path_factory.mktemp("cli")
    got = {}
    ref = threading.Thread(target=lambda: got.__setitem__(
        "repro", _cli_chain("repro.serve", J_ENV, d / "repro")))
    ref.start()
    got["repro_torch"] = _cli_chain("repro_torch.serve", ENV, d / "repro_torch")
    ref.join()
    return got


def _comparable(text):
    """CLI stdout without what may differ: the store's path, the value of
    the ``*.wall_ms`` rows and the ``lowered=`` count of the lookup row
    (Hopper's ``lower`` emits other entries)."""
    out = []
    for line in text.splitlines():
        if line.startswith("# serve store at "):
            line = "# serve store at" + line.split(" (", 1)[1]
        name, _, rest = line.partition(",")
        if name.endswith(".wall_ms"):
            line = f"{name},{rest.partition(',')[2]}"
        if name == "serve.lookup.latency_ms":
            line = line.rsplit(" lowered=", 1)[0]
        out.append(line)
    return out


@pytest.mark.parametrize("command", list(CLI_ARGS))
def test_cli_output_equals_the_reference(cli_runs, command):
    jrc, jout, jerr = cli_runs["repro"][command]
    trc, tout, terr = cli_runs["repro_torch"][command]
    assert jrc == 0, jerr
    assert trc == 0, terr
    assert _comparable(tout) == _comparable(jout)
    assert len(tout.splitlines()) > 5
    if command == "lookup":         # the warm command's artifact replayed
        assert "serve.cache.hit,1," in tout
        assert "serve.cache.miss,0," in tout


def test_importing_serve_loads_no_jax_and_touches_no_card():
    code = ("import sys, torch; import repro_torch.serve, "
            "repro_torch.serve.__main__; "
            "from repro_torch.kernels import _build as b; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert not torch.cuda.is_initialized() and b._lib is None; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
