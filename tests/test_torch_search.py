"""The port's scheduler against the JAX package's, on the CPU.

The cost model and the search are copies: for every registered workload
the port's schedule document equals ``repro.search.auto_schedule``'s in
every field but ``lowered``, and the cost model's numbers are equal, not
close.  ``lowered`` is the port's own: the launch parameters of the Hopper
kernels, held here to the contract that ``repro_torch.search.lower``
states (menus, shared-memory budget, ragged edges, counters).  The
``edge_schedule`` walk-through prints the cost-model lines of the JAX
example.
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.search as jsearch
from repro.configs.edgenext_s import CONFIG as J_CONFIG
from repro.configs.edgenext_s import reduced_edgenext as j_reduced
from repro.core import costmodel as jcost
from repro.core import fusion as jfusion
from repro.core import schedule as jschedule
from repro.core import workload as jworkload
from repro_torch import edge_schedule, obs
from repro_torch import search as tsearch
from repro_torch.configs.edgenext_s import CONFIG as T_CONFIG
from repro_torch.configs.edgenext_s import reduced_edgenext as t_reduced
from repro_torch.core import costmodel as tcost
from repro_torch.core import schedule as tschedule
from repro_torch.core import workload as tworkload
from repro_torch.kernels import rwkv_chunk as _wkv
from repro_torch.search import lower

GOLDEN = Path(__file__).parent / "golden"


@functools.lru_cache(maxsize=None)
def _schedules(name, **kw):
    """(JAX document, port document, port Schedule) of one search."""
    j = jsearch.auto_schedule(jsearch.get_workload(name), workload=name, **kw)
    t = tsearch.auto_schedule(tsearch.get_workload(name), workload=name, **kw)
    return dataclasses.asdict(j), dataclasses.asdict(t), t


def _cost_rows(nc):
    """Every number a costed network carries, in plain Python types."""
    return dict(
        latency=nc.latency_s, energy=nc.energy_j, edp=nc.edp,
        dram=nc.dram_bytes(), energy_pj=nc.energy_pj(),
        layers=[(lc.layer.name, lc.mapping, lc.compute_cycles,
                 lc.stall_cycles, dict(lc.traffic), lc.fused, lc.extra_macs)
                for lc in nc.layers])


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True],
                         ids=["edgenext-s", "edgenext-reduced"])
def test_cost_model_equals_the_reference(reduced):
    """cost_network under each Fig 8 configuration, evaluate_stack and
    normalized_stack: equal to the JAX package's live output."""
    jwl = jworkload.edgenext_workload(j_reduced() if reduced else J_CONFIG)
    twl = tworkload.edgenext_workload(t_reduced() if reduced else T_CONFIG)
    for _, kw in jschedule.CONFIG_STACK:
        assert _cost_rows(tcost.cost_network(twl, tcost.HWSpec(), **kw)) \
            == _cost_rows(jcost.cost_network(jwl, jcost.HWSpec(), **kw))
    assert [(r.name, _cost_rows(r.cost)) for r in tschedule.evaluate_stack(twl)] \
        == [(r.name, _cost_rows(r.cost)) for r in jschedule.evaluate_stack(jwl)]
    assert tschedule.normalized_stack(twl) == jschedule.normalized_stack(jwl)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def test_registry_is_the_reference_registry():
    assert tsearch.WORKLOADS == jsearch.WORKLOADS
    for name in tsearch.WORKLOADS + ("vit-tiny-b16",):
        assert tsearch.parse_workload(name) == jsearch.parse_workload(name)
        assert [dataclasses.astuple(l) for l in tsearch.get_workload(name)] \
            == [dataclasses.astuple(l) for l in jsearch.get_workload(name)]


@pytest.mark.parametrize("name,kw", [(w, {}) for w in jsearch.WORKLOADS] + [
    ("edgenext-reduced", {"dedup": False}),
    ("edgenext-s", {"tile_mode": "pow2"}),
    ("edgenext-s", {"spatial_mode": "pair"})],
                         ids=list(jsearch.WORKLOADS)
                         + ["edgenext-reduced-nodedup", "edgenext-s-pow2",
                            "edgenext-s-pair"])
def test_schedule_equals_the_reference_but_lowered(name, kw):
    """key, version, cost, tiles, groups, mappings, orders, placements,
    ... are equal; ``lowered`` lowers the same groups to the same kernels,
    with Hopper parameters."""
    jdoc, tdoc, _ = _schedules(name, **kw)
    assert set(tdoc) == set(jdoc)
    for field in jdoc:
        if field != "lowered":
            assert tdoc[field] == jdoc[field], field
    assert {k: v["kernel"] for k, v in tdoc["lowered"].items()} \
        == {k: v["kernel"] for k, v in jdoc["lowered"].items()}


@pytest.mark.parametrize("golden,kw", [
    ("edgenext_s_schedule.json", {}),
    ("edgenext_s_schedule_pair.json", {"spatial_mode": "pair"}),
])
def test_goldens_load_and_replay(golden, kw, tmp_path):
    """A fresh search reproduces the golden snapshots' groups, tiles and
    EDP.  The snapshots hold only those fields (and version, workload),
    so neither package's ``load_schedule`` rebuilds a schedule from them;
    the port's full artifact of the same search saves and loads back
    unchanged."""
    gold = json.loads((GOLDEN / golden).read_text())
    assert tsearch.load_schedule(GOLDEN / golden) is None
    assert jsearch.load_schedule(GOLDEN / golden) is None
    _, _, sched = _schedules("edgenext-s", **kw)
    tsearch.save_schedule(sched, tmp_path / "s.json")
    assert dataclasses.asdict(tsearch.load_schedule(tmp_path / "s.json")) \
        == dataclasses.asdict(sched)
    assert sched.version == gold["version"]
    assert [list(g) for g in sched.groups] == gold["groups"]
    assert sched.tiles == gold["tiles"]
    assert sched.cost["edp"] == pytest.approx(gold["cost"]["edp"])
    assert sched.cost["edp_tiled"] == pytest.approx(gold["cost"]["edp_tiled"])


def test_cache_has_its_own_namespace(tmp_path):
    """The port stores ``<workload>-hopper-<key>.json`` and replays it; an
    artifact of the JAX package under the same key is never replayed."""
    name = "edgenext-reduced"
    twl, jwl = tsearch.get_workload(name), jsearch.get_workload(name)
    jsearch.cached_search(jwl, workload=name, cache_dir=tmp_path)
    key = tsearch.schedule_key(twl, tcost.HWSpec())
    assert key == jsearch.schedule_key(jwl, jcost.HWSpec())
    assert [p.name for p in tmp_path.glob("*.json")] == [f"{name}-{key}.json"]
    with obs.tracing() as tr:
        first = tsearch.cached_search(twl, workload=name, cache_dir=tmp_path)
    assert tr.counters.get("cache.miss") == 1 and "cache.hit" not in tr.counters
    assert (tmp_path / f"{name}-hopper-{key}.json").exists()
    with obs.tracing() as tr:
        again = tsearch.cached_search(twl, workload=name, cache_dir=tmp_path)
    assert tr.counters.get("cache.hit") == 1
    assert dataclasses.asdict(again) == dataclasses.asdict(first)
    # verified on replay by the port's checker, which passes the port's own
    # artifact (a JAX one would fail its Hopper launch lint)
    with obs.tracing() as tr:
        checked = tsearch.cached_search(twl, workload=name,
                                        cache_dir=tmp_path, verify=True)
    assert tr.counters.get("cache.hit") == 1
    assert tr.counters.get("check.pass") == 1
    assert dataclasses.asdict(checked) == dataclasses.asdict(first)


# ---------------------------------------------------------------------------
# lowering for Hopper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jsearch.WORKLOADS)
def test_lowered_params_follow_the_hopper_contract(name):
    """Every emitted block is one its kernel is built for, matmul_ln's
    row buffer fits the budget, ``ragged == extent % block``, and the
    ``lower.kernel.*`` counters count the emitted entries."""
    layers = tsearch.get_workload(name)
    with obs.tracing() as tr:
        sched = tsearch.auto_schedule(layers, workload=name)
    kinds: dict = {}
    for key, lk in sched.lowered.items():
        kinds[lk["kernel"]] = kinds.get(lk["kernel"], 0) + 1
        ext = lower.launch_shape(layers, key, lk)
        blocks = {k: v for k, v in lk.items() if k.startswith("block_")}
        if lk["kernel"] == "fused_ibn":
            assert blocks == lower.FUSED_IBN_BLOCKS
            axes = {"m": "block_m", "f": "block_f"}
        elif lk["kernel"] == "flash_attention":
            assert blocks == lower.FLASH_ATTENTION_BLOCKS
            axes = {"q": "block_q", "k": "block_k"}
        elif lk["kernel"] == "matmul_ln":
            assert lk["block_m"] in lower.MATMUL_LN_BLOCK_M
            assert lk["block_k"] in lower.MATMUL_LN_BLOCK_K
            assert lk["block_m"] * ext["n"] * 4 <= lower.MATMUL_LN_SMEM_BYTES
            axes = {"m": "block_m", "k": "block_k"}
        else:
            assert lk["kernel"] == "rwkv_chunk" and not blocks
            assert set(ext) == {"bh", "t", "k", "v"}
            assert {a: lk[a] for a in ext} == ext         # the lowered extents
            assert 1 <= lk["chunk"] <= ext["t"]
            assert _wkv.smem_bytes(lk["chunk"], ext["k"]) <= _wkv.SMEM_LIMIT
            assert lk["ragged"] == ({"t": ext["t"] % lk["chunk"]}
                                    if ext["t"] % lk["chunk"] else {})
            continue
        assert lk["ragged"] == {a: ext[a] % lk[b] for a, b in axes.items()}, key
    # a workload with a scan layer is searched twice (at a fixed chunk,
    # then at the chosen one), and each search lowers its schedule
    runs = 2 if any(l.op == "scan" for l in layers) else 1
    counters = {k[len("lower.kernel."):]: v for k, v in tr.counters.items()
                if k.startswith("lower.kernel.")}
    assert counters == {k: n * runs for k, n in kinds.items()}
    assert tr.counters.get("lower.groups_unlowered", 0) \
        == (len(sched.groups) - len(sched.lowered)) * runs


@pytest.mark.parametrize("name,key,want", [
    # stage 1 of EdgeNeXt-S: 64x64 pixels, dim 48, expansion 4
    ("edgenext-s", "s0.conv0.pw1 + s0.conv0.pw2",
     {"m": 4096, "d": 48, "f": 192, "do": 48}),
    # XCA of stage 2: 4 heads of 24 channels over 32x32 tokens
    ("edgenext-s", "s1.sdta0.qk", {"bh": 4, "q": 24, "k": 24, "d": 1024}),
    ("edgenext-s", "s1.sdta0.proj + s1.sdta0.ln_m",
     {"m": 1024, "k": 96, "n": 96}),
    # ViT-Tiny: 196 tokens, 3 heads of 64, MLP 192 -> 768 -> 192
    ("vit-tiny", "blk0.qk", {"bh": 3, "q": 196, "k": 196, "d": 64}),
    ("vit-tiny", "blk0.fc1 + blk0.fc2",
     {"m": 196, "d": 192, "f": 768, "do": 192}),
    ("vit-tiny", "blk0.proj + blk0.ln2", {"m": 196, "k": 192, "n": 192}),
    # RWKV-6 1.6B at B = 1: 32 heads of a [64, 64] state over 512 tokens;
    # RecurrentGemma's LRU: one [1, 2560] state over 448 tokens
    ("rwkv6", "blk0.tmix.wkv", {"bh": 32, "t": 512, "k": 64, "v": 64}),
    ("recurrentgemma", "blk0.lru", {"bh": 1, "t": 448, "k": 1, "v": 2560}),
])
def test_launch_shape_is_the_models_shape(name, key, want):
    layers = tsearch.get_workload(name)
    lk = _schedules(name)[2].lowered[key]
    assert lower.launch_shape(layers, key, lk) == want


@pytest.mark.parametrize("name,key", [("rwkv6", "blk0.tmix.wkv"),
                                      ("recurrentgemma", "blk0.lru")])
def test_scan_lowers_to_the_cards_chunk(name, key):
    """The searched chunk (8 for both, the paper's accelerator's choice) is
    snapped to ``rwkv_chunk.CHUNK``, the chunk the kernel runs fastest at
    on the H100, as the block menus are; ragged T stays T % chunk."""
    lowered = _schedules(name)[2].lowered
    scans = [lk for lk in lowered.values() if lk["kernel"] == "rwkv_chunk"]
    assert scans and all(lk["chunk"] == _wkv.CHUNK == lower.WKV_CHUNK
                         for lk in scans)
    lk = lowered[key]
    assert lk["ragged"] == ({"t": lk["t"] % _wkv.CHUNK} if lk["t"] % _wkv.CHUNK
                            else {})


@pytest.mark.parametrize("n,block_m", [(2560, 16),(2048, 16), (512, 64),
                                       (304, 64), (96, 64), (5120, 8)])
def test_matmul_ln_row_block_shrinks_to_the_budget(n, block_m):
    mac = tworkload.Layer("mac", "pwconv", k=n, c=n, ox=448)
    norm = tworkload.Layer("ln", "norm", c=n, ox=448)
    lk = lower.lower_matmul_ln(mac, norm, tile_x=64, tile_c=128)
    assert lk.params == {"block_m": block_m, "block_k": 64}
    assert lk.ragged == {"m": 448 % block_m, "k": n % 64}


def test_matmul_ln_too_wide_for_the_budget_is_left_unlowered():
    mac = tworkload.Layer("mac", "pwconv", k=5121, c=64, ox=8)
    norm = tworkload.Layer("ln", "norm", c=5121, ox=8)
    assert lower.lower_matmul_ln(mac, norm, tile_x=64, tile_c=128) is None


def test_blocks_cover_small_and_ragged_extents():
    """Menu blocks larger than a sub-8 extent are kept (the kernels mask),
    with the whole extent reported ragged; a searched tile between menu
    values snaps down; the reference's 197-pixel, d_ff=304 IBN goes ragged
    on both axes."""
    for ext in (1, 2, 3, 5, 7):
        b, r = lower._snap(64, lower.MATMUL_LN_BLOCK_M, ext)
        assert (b, r) == (8, ext)
    assert lower._snap(48, lower.MATMUL_LN_BLOCK_M, 1000) == (32, 1000 % 32)
    assert lower._snap(4, lower.MATMUL_LN_BLOCK_K, 1000) == (16, 1000 % 16)
    assert lower._snap(64, lower.MATMUL_LN_BLOCK_M, 20) == (32, 20)
    lk = lower.lower_matmul_ln(tworkload.Layer("m", "pwconv", k=24, c=13, ox=7),
                               tworkload.Layer("n", "norm", c=24, ox=7),
                               tile_x=7, tile_c=13)
    assert lk.params == {"block_m": 8, "block_k": 16}
    assert lk.ragged == {"m": 7, "k": 13}
    lk = lower.lower_ibn(tworkload.Layer("e", "pwconv", k=304, c=160, ox=197),
                         tworkload.Layer("p", "pwconv", k=160, c=304, ox=197))
    assert lk.params == lower.FUSED_IBN_BLOCKS
    assert lk.ragged == {"m": 197 % 64, "f": 304 % 64}


# ---------------------------------------------------------------------------
# the walk-through
# ---------------------------------------------------------------------------


def _jax_cost_model_lines():
    """The cost-model lines of ``examples/edge_schedule.py``, from the JAX
    package's functions, with that example's formats."""
    wl = jworkload.edgenext_workload(J_CONFIG)
    hw = jcost.HWSpec()
    out = [f"EdgeNeXt-S: {len(wl)} layers, "
           f"{jworkload.total_macs(wl)/1e9:.2f} GMACs, "
           f"{len(jworkload.ibn_groups(wl))} inverted bottlenecks",
           f"accelerator: {hw.rows}x{hw.cols} PEs @ {hw.clock_hz/1e6:.0f}MHz"
           f" -> {hw.peak_macs_per_s/1e9:.1f} GMAC/s, "
           f"peak {hw.peak_tops_per_w:.2f} TOPS/W (paper: 1.39)",
           "\n-- Fig 8: optimization stack (normalized to baseline) --"]
    for r in jschedule.normalized_stack(wl, hw):
        out.append(f"  {r['config']:15s} latency={r['latency']:.3f} "
                   f"energy={r['energy']:.3f} edp={r['edp']:.3f} "
                   f"fps={r['fps']:6.2f}")
    share = jfusion.ibn_dram_share(wl, hw.act_budget_bytes)
    out.append(f"\n-- Fig 5 -- IBN share of DRAM traffic: {100*share:.1f}% "
               f"(paper: 63.6%)")
    exp, _, proj = jworkload.ibn_groups(wl)[0]
    tile = jfusion.optimize_tile(exp, proj, local_buffer=hw.output_rf_bytes)
    out.append(f"   fusion tile (ZigZag-style search): x={tile.tile_x} "
               f"c={tile.tile_c} buffer={tile.buffer_bytes}B "
               f"<= RF {hw.output_rf_bytes}B")
    final = jschedule.evaluate_stack(wl, hw)[-1].cost
    out.append(f"\n-- Table I -- fps={final.fps:.2f} (paper 13.16), "
               f"chip power={final.chip_power_w*1e3:.1f}mW (paper 18.4), "
               f"FPS/W={final.fps_per_w_chip:.0f} (paper 731)")
    sched = jsearch.auto_schedule(wl, hw, workload="edgenext-s")
    out += ["\n-- repro.search auto-scheduler --",
            f"  groups={len(sched.groups)} spill_edges={len(sched.edges)} "
            f"fused_nonlinear={len(sched.fused_nonlinear)}",
            f"  auto edp={sched.cost['edp']:.4g} vs hand "
            f"+ibn-fusion edp={final.edp:.4g} "
            f"(ratio {sched.cost['edp']/final.edp:.3f} <= 1)"]
    return out


def test_edge_schedule_on_cpu_prints_the_reference_cost_model(capsys):
    """``python -m repro_torch.edge_schedule --device cpu`` at full width:
    the cost-model lines of the JAX example, but for the package named in
    the auto-scheduler's header and the Hopper blocks of the lowered
    fused_ibn line; then one max|delta| line per
    lowered fused_ibn entry of the first stage, per lowered matmul_ln
    entry and for the depthwise conv, each exactly 0 on the CPU, where
    the entry points take their plain versions."""
    edge_schedule.main(["--device", "cpu"])
    lines = capsys.readouterr().out.split("\n")
    want = "\n".join(_jax_cost_model_lines()).split("\n")
    header = lines.index("-- repro_torch.search auto-scheduler --")
    assert lines[:header] == want[:header]
    assert want[header] == "-- repro.search auto-scheduler --"
    assert lines[header + 1:header + 3] == want[header + 1:header + 3]
    assert lines[header + 3] == ("  lowered fused_ibn [s0.conv0.pw1 + "
                                 "s0.conv0.pw2]: block_m=64 block_f=64")
    deltas = [ln for ln in lines if "max|delta|" in ln]
    assert [ln.split()[0] for ln in deltas] == ["C3"] * 3 + ["C2"] * 3 + ["C1"]
    assert "s3.sdta0.proj + s3.sdta0.ln_m] M=64 K=304 N=304" in deltas[5]
    assert all(ln.endswith("max|delta| = 0.00e+00") for ln in deltas)


def test_edge_schedule_without_a_card_raises():
    if edge_schedule.torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        edge_schedule.main([])


def test_importing_the_scheduler_loads_no_jax_and_builds_nothing():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; import repro_torch.search, repro_torch.edge_schedule, "
            "repro_torch.kernels._build as b; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert b._lib is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={"PYTHONPATH": str(root / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
