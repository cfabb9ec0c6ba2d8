"""The port's design-space sweep, trace exporters, explain report and
search CLI against the JAX package's, on the CPU.

``repro_torch.search.dse``, ``repro_torch.obs.{exporters,explain}`` and
``python -m repro_torch.search`` are copies of the reference's.  Their
results must be the reference's: sweep points equal in every field (the
schedule in every field but ``lowered``, which is the port's Hopper
lowering), the same explain text, the same trace and BENCH-row structure,
and CLI output equal line for line but for the ``lowered_kernels=`` count
and wall-clock numbers.  Also the ports of the reference's tests of these
modules in ``tests/test_obs.py``, ``test_search.py`` and
``test_search_perf.py``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.obs as jobs
import repro.search as jsearch
import repro.search.__main__ as jcli
from repro.core.costmodel import HWSpec as JHWSpec
from repro_torch import obs
from repro_torch import search as tsearch
from repro_torch.core.costmodel import HWSpec
from repro_torch.search import (auto_schedule, dse, edp_best, get_workload,
                                hw_variants, pareto_front, sweep,
                                sweep_memory)
from repro_torch.search import __main__ as tcli
from repro_torch.search.perf import PerfRecorder

ROOT = Path(__file__).resolve().parents[1]
HW = HWSpec()
KB = 1024
_SIZINGS = {"rf": (16 * KB, 32 * KB)}


def _wl():
    return get_workload("edgenext-reduced")


def _run(*args, timeout=300):
    """``python -m repro_torch.search`` with ``args`` in a fresh process."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"]}
    return subprocess.run([sys.executable, "-m", "repro_torch.search", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)


def _point(p):
    """Every field of a DSE point, the schedule's but ``lowered``."""
    d = dataclasses.asdict(p)
    d["schedule"].pop("lowered")
    return d


# ---------------------------------------------------------------------------
# the sweeps equal the reference's
# ---------------------------------------------------------------------------


def test_sweep_points_equal_the_reference():
    kw = dict(pe_shapes=((8, 8), (16, 16)), sram_kb=(256, 512))
    t = sweep(_wl(), hw_variants(HW, **kw), workload="edgenext-reduced")
    j = jsearch.sweep(jsearch.get_workload("edgenext-reduced"),
                      jsearch.hw_variants(JHWSpec(), **kw),
                      workload="edgenext-reduced")
    assert len(t) == 4
    assert [_point(p) for p in t] == [_point(p) for p in j]
    assert [p.label for p in pareto_front(t)] == \
        [p.label for p in jsearch.pareto_front(j)]
    assert edp_best(t).label == jsearch.edp_best(j).label


@functools.lru_cache(maxsize=None)
def _memory_points(parallel):
    sizings = {"rf": (16 * KB, 32 * KB), "sram": (256 * KB, 512 * KB)}
    t = sweep_memory(_wl(), HW, sizings=sizings,
                     workload="edgenext-reduced", parallel=parallel)
    j = jsearch.sweep_memory(jsearch.get_workload("edgenext-reduced"),
                             JHWSpec(), sizings=sizings,
                             workload="edgenext-reduced", parallel=parallel)
    return t, j


@pytest.mark.parametrize("parallel", [0, 2])
def test_memory_sweep_points_equal_the_reference(parallel):
    t, j = _memory_points(parallel)
    assert len(t) == 4 and [p.mem for p in t] == [p.mem for p in j]
    assert [_point(p) for p in t] == [_point(p) for p in j]
    # the port's lowering on each point, the same serial or pooled
    assert [p.schedule.lowered for p in t] == \
        [p.schedule.lowered for p in _memory_points(0)[0]]


# ---------------------------------------------------------------------------
# ports of the reference's tests/test_search.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["vit-tiny", "efficientvit-b0"])
def test_dse_pareto_front_valid(name):
    pts = sweep(get_workload(name), hw_variants(
        HW, pe_shapes=((8, 8), (16, 16), (32, 32)), sram_kb=(256, 512)),
        workload=name)
    front = pareto_front(pts)
    assert front, name
    # no front point is dominated by any swept point
    for p in front:
        assert not any(dse.dominates(q, p) for q in pts), p.label
    # every off-front point is dominated by some front point
    on = {p.label for p in front}
    for p in pts:
        if p.label not in on:
            assert any(dse.dominates(q, p) for q in front), p.label
    assert edp_best(pts).edp <= min(p.edp for p in front) * (1 + 1e-9)


@functools.lru_cache(maxsize=None)
def _edgenext_s():
    return auto_schedule(get_workload("edgenext-s"), HW,
                         workload="edgenext-s")


def test_golden_edgenext_schedule():
    """The searched EdgeNeXt-S schedule (groups + tiles + EDP)
    reproduces the reference's checked-in snapshot."""
    sched = _edgenext_s()
    gold = json.loads((ROOT / "tests" / "golden" /
                       "edgenext_s_schedule.json").read_text())
    assert gold["version"] == sched.version
    assert [list(g) for g in sched.groups] == gold["groups"]
    assert sched.tiles == gold["tiles"]
    assert sched.cost["edp"] == pytest.approx(gold["cost"]["edp"])
    assert sched.cost["edp_tiled"] == \
        pytest.approx(gold["cost"]["edp_tiled"])


def test_memory_sweep_beats_fixed_paper_spec():
    """On EdgeNeXt-S at least one swept L1/L2 sizing lands on the Pareto
    front with lower EDP than the fixed paper spec, and the paper sizing
    reproduces the paper EDP exactly (it is a grid point)."""
    pts = sweep_memory(get_workload("edgenext-s"), HW,
                       sizings={"rf": (16 * KB, 32 * KB),
                                "sram": (512 * KB, 1024 * KB)},
                       workload="edgenext-s")
    base = next(p for p in pts
                if dict(p.mem) == {"rf": 32 * KB, "sram": 512 * KB})
    assert base.edp == _edgenext_s().cost["edp"]
    front = pareto_front(pts)
    assert any(p.edp < base.edp for p in front)
    for p in front:
        assert not any(dse.dominates(q, p) for q in pts), p.label
    assert {len(p.mem) for p in pts} == {2}


def test_cli_smoke(tmp_path):
    out = tmp_path / "sched.json"
    r = _run("--workload", "edgenext-reduced", "--out", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cost.edp" in r.stdout
    art = json.loads(out.read_text())
    assert art["workload"] == "edgenext-reduced"
    assert art["lowered"]


# ---------------------------------------------------------------------------
# ports of the reference's tests/test_search_perf.py
# ---------------------------------------------------------------------------


def test_sweep_memory_dedup_matches_brute():
    """A sweep-wide shared memo does not leak decisions across variants:
    every point equals its from-scratch counterpart."""
    sizings = {"rf": (16 * KB, 32 * KB), "sram": (256 * KB, 512 * KB)}
    fast = sweep_memory(_wl(), HW, sizings=sizings, dedup=True)
    brute = sweep_memory(_wl(), HW, sizings=sizings, dedup=False)
    assert len(fast) == len(brute) == 4
    for a, b in zip(fast, brute):
        assert a.mem == b.mem
        assert dataclasses.asdict(a.schedule) == \
            dataclasses.asdict(b.schedule)


def test_sweep_memory_parallel_matches_serial():
    """The process-pool fan-out returns the serial points and merges the
    workers' PerfRecorder tables back: phase times and memo counters are
    not the empty recorder a pool would otherwise leave."""
    serial = sweep_memory(_wl(), HW, sizings=_SIZINGS)
    perf = PerfRecorder()
    par = sweep_memory(_wl(), HW, sizings=_SIZINGS, parallel=2, perf=perf)
    assert [p.label for p in par] == [p.label for p in serial]
    for a, b in zip(par, serial):
        assert dataclasses.asdict(a.schedule) == \
            dataclasses.asdict(b.schedule)
    for phase in ("spatial", "partition", "temporal", "evaluate"):
        assert perf.phase_s.get(phase, 0.0) > 0.0, (phase, perf.phase_s)
    hits = sum(v for k, v in perf.counters.items() if k.endswith(".hit"))
    miss = sum(v for k, v in perf.counters.items() if k.endswith(".miss"))
    assert hits + miss > 0 and perf.hit_rate() > 0.0
    assert perf.rows("perf")


def test_cli_profile_smoke():
    r = _run("--workload", "edgenext-reduced", "--profile")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "perf.auto.speedup," in r.stdout
    assert "perf.memo.hit_rate," in r.stdout
    assert "cost.edp" in r.stdout


# ---------------------------------------------------------------------------
# ports of the reference's tests/test_obs.py, and the exporters and the
# explain report against the reference's
# ---------------------------------------------------------------------------


def test_dse_span_wraps_auto_serial_and_parallel():
    wl = _wl()
    with obs.tracing() as t:
        pts = sweep_memory(wl, HW, sizings=_SIZINGS,
                           workload="edgenext-reduced")
    assert [r.name for r in t.roots] == ["dse"]
    autos = [c for c in t.roots[0].children if c.name == "auto"]
    assert len(autos) == len(pts) == 2

    with obs.tracing() as tp:
        ptsp = sweep_memory(wl, HW, sizings=_SIZINGS,
                            workload="edgenext-reduced", parallel=2)
    dse_span = tp.roots[0]
    autos = [c for c in dse_span.children if c.name == "auto"]
    assert len(autos) == 2
    # worker trees were merged back: labeled, rebased into the dse
    # interval, each on its own track id
    assert sorted(a.attrs.get("worker", "") for a in autos) == \
        ["worker0", "worker1"]
    for a in autos:
        assert dse_span.t0 <= a.t0 <= dse_span.t0 + dse_span.dur_s
        assert a.tid != dse_span.tid
    assert tp.counters.get("mapper.spatial.pairs_enumerated", 0) > 0
    assert [p.edp for p in ptsp] == [p.edp for p in pts]


def _traced(mod):
    with mod.tracing() as t:
        with mod.span("auto", workload="w"):
            mod.count("fusion.groups", 2)
            mod.gauge("auto.edp", 1.5)
            mod.event("cache.replay", outcome="hit")
    return t


def _shape(doc):
    """A Chrome trace without its clock: the events' names, phases, args
    and keys, and the counters and gauges."""
    return ([(e["name"], e["ph"], e.get("args"), sorted(e))
             for e in doc["traceEvents"]],
            {k: v for k, v in doc["otherData"].items() if k != "phase_s"})


def test_chrome_trace_and_bench_rows():
    t = _traced(obs)
    doc = obs.chrome_trace(t)
    names = [e["name"] for e in doc["traceEvents"]]
    assert names == ["auto", "cache.replay"]
    ev = doc["traceEvents"][0]
    assert ev["ph"] == "X" and ev["dur"] >= 0 and \
        ev["args"] == {"workload": "w"}
    assert doc["otherData"]["counters"] == {"fusion.groups": 2}
    json.dumps(doc)                            # serializable end to end
    rows = obs.bench_rows(t)
    byname = {n: v for n, v, _ in rows}
    assert byname["search.obs.spans"] == 2.0
    assert byname["search.obs.fusion.groups"] == 2.0
    assert byname["search.obs.auto.edp"] == 1.5
    # the reference's exporters on the same spans
    j = _traced(jobs)
    assert _shape(doc) == _shape(jobs.chrome_trace(j))
    assert [(n, v, note) for n, v, note in rows] == \
        [(n, v, note) for n, v, note in jobs.bench_rows(j)]


def test_traced_search_exports_like_the_reference():
    """A traced search of the same workload gives the reference's span
    names in the same order and the same BENCH rows."""
    with obs.tracing() as t:
        auto_schedule(_wl(), HW, workload="edgenext-reduced")
    with jobs.tracing() as j:
        jsearch.auto_schedule(jsearch.get_workload("edgenext-reduced"),
                              JHWSpec(), workload="edgenext-reduced")
    names = lambda doc: [e["name"] for e in doc["traceEvents"]]  # noqa: E731
    assert names(obs.chrome_trace(t)) == names(jobs.chrome_trace(j))
    keep = lambda rows: [(n, v) for n, v, _ in rows  # noqa: E731
                         if not n.startswith("search.obs.lower.")]
    assert keep(obs.bench_rows(t)) == keep(jobs.bench_rows(j))


def test_explain_report_content():
    wl = _wl()
    sched = auto_schedule(wl, HW, workload="edgenext-reduced")
    out = obs.explain_schedule(wl, sched)      # hw rebuilt from artifact
    for section in ("## Schedule explain: edgenext-reduced",
                    "### Per-level traffic / energy breakdown",
                    "### Per-layer mapping decisions",
                    "### Fusion groups"):
        assert section in out
    for level in ("rf", "sram", "dram"):
        assert f"| {level} |" in out
    for name in sched.mappings:
        assert name in out
    assert "**total**" in out and "100.0%" in out
    # every markdown table row keeps its header's column count: mapping
    # labels carry '|' and arrive escaped
    header_cols = None
    for line in out.splitlines() + [""]:
        if not line.startswith("|"):
            header_cols = None
            continue
        cols = line.count("|") - line.count("\\|")
        if header_cols is None:
            header_cols = cols
        assert cols == header_cols, line
    # explicit hw and artifact-reconstructed hw agree exactly
    assert out == obs.explain_schedule(wl, sched, HW)


# the reference's report takes every group's tile for a depth-first one
# and raises KeyError on a scan group's (rwkv6, recurrentgemma); the port
# keeps the copy (ROADMAP, queue 3)
@pytest.mark.parametrize("name", [w for w in jsearch.WORKLOADS
                                  if w not in ("rwkv6", "recurrentgemma")])
def test_explain_text_equals_the_reference(name):
    tl, jl = get_workload(name), jsearch.get_workload(name)
    t = auto_schedule(tl, HW, workload=name)
    j = jsearch.auto_schedule(jl, JHWSpec(), workload=name)
    assert obs.explain_schedule(tl, t) == jobs.explain_schedule(jl, j)


def test_cli_trace_explain_smoke(tmp_path):
    trace = tmp_path / "t.json"
    r = _run("--workload", "edgenext-reduced", "--trace", str(trace),
             "--explain")
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(trace.read_text())
    by = {}
    for e in doc["traceEvents"]:
        by.setdefault(e["name"], []).append(e)
    auto = by["auto"][0]

    def inside(e):
        return (auto["ts"] <= e["ts"] and
                e["ts"] + e["dur"] <= auto["ts"] + auto["dur"] + 1e3)

    for name in ("spatial", "fusion", "tiles", "lower", "evaluate"):
        assert name in by, sorted(by)
        assert all(inside(e) for e in by[name]), name
    assert doc["otherData"]["counters"]["fusion.groups"] > 0
    assert "search.obs.spans," in r.stdout
    assert "### Per-layer mapping decisions" in r.stdout
    assert "# wrote trace" in r.stdout


def test_cli_dse_trace_nests_autos(tmp_path):
    trace = tmp_path / "t.json"
    r = _run("--workload", "edgenext-reduced", "--dse-mem", "rf",
             "--trace", str(trace))
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(trace.read_text())
    dse_ev = [e for e in doc["traceEvents"] if e["name"] == "dse"]
    autos = [e for e in doc["traceEvents"] if e["name"] == "auto"]
    assert len(dse_ev) == 1 and len(autos) >= 2
    lo, hi = dse_ev[0]["ts"], dse_ev[0]["ts"] + dse_ev[0]["dur"]
    assert all(lo <= a["ts"] <= hi for a in autos)


# ---------------------------------------------------------------------------
# the CLI against the reference's: output and exit codes
# ---------------------------------------------------------------------------


def _comparable(text):
    """CLI stdout without what may differ: the ``lowered_kernels=``
    count, ``search.obs.lower.*`` rows (the port's ``lower`` counts its
    own kernels) and the trace's span count."""
    out = []
    for line in text.splitlines():
        if line.startswith("groups="):
            line = line.rsplit(" lowered_kernels=", 1)[0]
        if line.startswith(("search.obs.lower.", "search.obs.spans,",
                            "# wrote trace")):
            continue
        out.append(line)
    return out


def _both(capsys, *args):
    """(reference stdout, exit code), (port stdout, exit code) of one
    command line, each package's CLI run in this process."""
    res = []
    for main in (jcli.main, tcli.main):
        rc = main(list(args))
        res.append((capsys.readouterr().out, rc))
    return res


@pytest.mark.parametrize("args", [
    ("--workload", "edgenext-reduced", "--check", "--explain"),
    ("--workload", "rwkv6", "--check"),
    ("--workload", "edgenext-reduced", "--dse-mem", "rf", "--explain"),
    ("--workload", "efficientvit-b0", "--dse"),
], ids=["check-explain", "rwkv6-check", "dse-mem", "dse"])
def test_cli_output_equals_the_reference(capsys, args):
    (jout, jrc), (tout, trc) = _both(capsys, *args)
    assert trc == jrc == 0
    assert _comparable(tout) == _comparable(jout)


def test_cli_trace_output_equals_the_reference(capsys, tmp_path):
    (jout, jrc), (tout, trc) = _both(
        capsys, "--workload", "edgenext-reduced", "--trace",
        str(tmp_path / "t.json"))
    assert trc == jrc == 0
    assert _comparable(tout) == _comparable(jout)
    assert any(line.startswith("search.obs.lower.kernel.")
               for line in tout.splitlines())


def test_cli_check_exit_codes_equal_the_reference(capsys, tmp_path):
    """``--check`` exits 0 on a clean schedule and 1 on a tampered
    artifact replayed from the cache; a bad command line exits 2."""
    for pkg, search, main in (("repro", jsearch, jcli.main),
                              ("repro_torch", tsearch, tcli.main)):
        d = tmp_path / pkg
        search.cached_search(search.get_workload("edgenext-reduced"),
                             workload="edgenext-reduced", cache_dir=d)
        args = ["--workload", "edgenext-reduced", "--cache-dir", str(d),
                "--check"]
        assert main(args) == 0
        art, = d.glob("edgenext-reduced-*.json")
        doc = json.loads(art.read_text())
        doc["cost"]["edp"] *= 3.0
        art.write_text(json.dumps(doc))
        assert main(args) == 1
        assert "check,cost.edp_identity," in capsys.readouterr().out
        for bad in (["--workload", "no-such-net"],
                    ["--cache-dir", str(d), "--profile"]):
            with pytest.raises(SystemExit) as e:
                main(bad)
            assert e.value.code == 2, (pkg, bad)


def test_importing_the_new_modules_loads_no_jax_and_touches_no_card():
    """The checker, the sweep (whose pool workers run the search) and the
    exporters import neither JAX nor the JAX package, and no import
    initialises CUDA, though ``search.lower`` imports the kernel
    wrappers."""
    code = ("import sys, torch; import repro_torch.check, "
            "repro_torch.check.__main__, repro_torch.search.dse, "
            "repro_torch.search.__main__, repro_torch.obs; "
            "from repro_torch.kernels import _build as b; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert not torch.cuda.is_initialized() and b._lib is None; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
