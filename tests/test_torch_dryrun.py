"""The port's dry-run (``launch.dryrun``, ``launch.optsweep``,
``core.hloanalysis``, ``core.opcount``) against the JAX package's, on the
CPU.

The cells, the optimised sweep's plans and the roofline arithmetic are the
reference's.  The counts come from a rank's program traced on the meta
device, and are held to JAX where JAX has the same number:

- FLOPs: each family's prefill and decode at reduced size in a world of
  one against the ``dot_general`` FLOPs of ``jax.make_jaxpr`` of the JAX
  step, dead code removed (``dce_jaxpr``; XLA's compile removes it too),
  sub-jaxprs walked, a ``scan`` body counted times its length.  The JAX
  functions the port replaces by kernels (``models.attention``'s
  ``flash_attention`` and ``flash_attention_banded``, ``models.rwkv6``'s
  ``wkv_chunked``) are wrapped in a named ``jax.jit`` while the jaxpr is
  made and counted by the port's formulas (``core.opcount``), as the port
  counts its kernels: the JAX blocks compute masked score tiles the
  kernels skip.
- Argument and output bytes: a rank's on a (2, 2) mesh against
  ``memory_analysis()`` of the reference dry-run's jit of the same step and
  shardings on 4 forced CPU devices (one subprocess).  XLA's executable
  takes no argument its program does not read (a prefill's LM head), as
  the port's count; its output size also counts the flat output tuple's
  table of 8-byte pointers, which the port has no counterpart of.

The meta trace is also held to real runs of the same programs: a CPU run
in one process (every count), and a world of 4 gloo ranks (each rank's
collectives record).
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.extend.core as jcore
import pytest
import torch
from jax._src.interpreters import partial_eval as pe

import repro.core.hloanalysis as J
import repro.models.attention as jattn
import repro.models.rwkv6 as jrwkv
from repro.configs import base as jbase
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.launch import specs as jspecs
from repro.runtime import build_decode_step as j_build_decode_step
from repro.runtime import build_prefill_step as j_build_prefill_step
from repro_torch import configs as TC
from repro_torch.core import hloanalysis as H
from repro_torch.core import opcount
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, optsweep
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import param_specs
from repro_torch.models import rwkv6 as trwkv

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
AXES = ("data", "model")
WORLD_S = 120


def _meta_mesh(shape=(1, 1), coords=None):
    return mesh_lib.abstract_mesh(shape, AXES, coords or {a: 0 for a in AXES},
                                  device="meta")


def _cell(arch, shape_name):
    return (TC.reduced(TC.get_config(arch)),
            TC.reduced_shape(TC.SHAPES_BY_NAME[shape_name]))


# ---------------------------------------------------------------------------
# Cells, plans, constants and the roofline's arithmetic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_plans():
    """The reference's ``--list`` and its ``cell_plan`` of every cell, read
    in a subprocess: importing ``repro.launch.dryrun`` sets the 512-device
    ``XLA_FLAGS``."""
    script = textwrap.dedent("""
        import contextlib, io, json, sys
        from repro.configs import ARCHS, applicable_shapes, get_config
        from repro.launch import dryrun, optsweep
        sys.argv = ["dryrun", "--list"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.main()
        plans = {f"{a} {s.name}": optsweep.cell_plan(a, s.kind)
                 for a in sorted(ARCHS) for s in applicable_shapes(get_config(a))}
        print(json.dumps({"list": buf.getvalue(), "plans": plans}))
    """)
    out = subprocess.run([sys.executable, "-c", script], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_list_gives_the_reference_cells(reference_plans, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main()
    assert buf.getvalue() == reference_plans["list"]
    assert len(buf.getvalue().splitlines()) == 33


def test_cell_plan_equals_the_reference(reference_plans):
    got = {f"{a} {s.name}": optsweep.cell_plan(a, s.kind)
           for a in sorted(TC.ARCHS) for s in TC.applicable_shapes(TC.get_config(a))}
    assert got == reference_plans["plans"]


def test_shape_cells_equal_the_reference():
    assert [vars(s) for s in TC.ALL_SHAPES] == [vars(s) for s in jbase.ALL_SHAPES]
    assert sorted(TC.SHAPES_BY_NAME) == sorted(jbase.SHAPES_BY_NAME)
    for arch in TC.ARCHS:
        assert [s.name for s in TC.applicable_shapes(TC.get_config(arch))] == \
            [s.name for s in jbase.applicable_shapes(jget(arch))]


@pytest.mark.parametrize("serve_bf16", [False, True])
def test_param_specs_equal_the_reference(serve_bf16):
    for arch in sorted(TC.ARCHS):
        got = [(s.shape, str(s.dtype).split(".")[-1]) for s in
               jax.tree.leaves(param_specs(TC.get_config(arch), serve_bf16=serve_bf16),
                               is_leaf=lambda x: hasattr(x, "dtype"))]
        want = [(tuple(s.shape), str(s.dtype)) for s in
                jax.tree.leaves(jspecs.param_specs(jget(arch), serve_bf16=serve_bf16))]
        assert sorted(got) == sorted(want), arch


def test_hloanalysis_arithmetic_equals_the_reference():
    for op in H.COLLECTIVE_OPS:
        mine, theirs = H.CollectiveStats(3, 1000, 7000), J.CollectiveStats(3, 1000, 7000)
        assert mine.wire_bytes(op) == theirs.wire_bytes(op)
    record = {"all-reduce": [2, 100, 100], "all-gather": [1, 64, 16],
              "reduce-scatter": [4, 10, 40], "collective-permute": [1, 8, 8]}
    mine = H.collective_stats(record)
    theirs = {k: J.CollectiveStats(*v) for k, v in record.items()}
    assert H.collective_wire_bytes(mine) == J.collective_wire_bytes(theirs) == 312.0
    for n, t, bwd in ((1_000_000, 4096, True), (7, 3, False)):
        assert H.model_flops(n, t, backward=bwd) == J.model_flops(n, t, backward=bwd)
    for f, b, c in ((1e15, 1e12, 1e9), (1e12, 1e13, 1e9), (1e9, 1e9, 1e12)):
        mine, theirs = H.Roofline(f, b, c), J.Roofline(f, b, c)
        assert mine.compute_s == pytest.approx(theirs.compute_s * J.PEAK_FLOPS / H.PEAK_FLOPS)
        assert mine.memory_s == pytest.approx(theirs.memory_s * J.HBM_BW / H.HBM_BW)
        assert mine.collective_s == pytest.approx(theirs.collective_s * J.ICI_BW / H.LINK_BW)
        assert mine.step_s == max(mine.compute_s, mine.memory_s, mine.collective_s)
        terms = {"compute": mine.compute_s, "memory": mine.memory_s,
                 "collective": mine.collective_s}
        assert mine.bound == max(terms, key=terms.get)
        assert mine.roofline_fraction == pytest.approx(mine.compute_s / mine.step_s)
    assert (H.PEAK_FLOPS, H.HBM_BW, H.LINK_BW, H.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)


# ---------------------------------------------------------------------------
# FLOPs against the JAX step's jaxpr
# ---------------------------------------------------------------------------


def _kernel_jit(fn, name):
    fn.__name__ = name
    return jax.jit(fn)


@pytest.fixture(scope="module")
def named_kernels():
    """The JAX functions that the port's kernels replace, each wrapped in a
    ``jax.jit`` whose name carries its masks or chunk."""
    fa, band, wkv = jattn.flash_attention, jattn.flash_attention_banded, jrwkv.wkv_chunked

    def attention(q, k, v, causal=True, window=None, *a, **kw):
        return _kernel_jit(lambda q, k, v: fa(q, k, v, causal, window, *a, **kw),
                           f"kernel_attention__{int(causal)}__{window}")(q, k, v)

    def banded(q, k, v, window, *a, **kw):
        return _kernel_jit(lambda q, k, v: band(q, k, v, window, *a, **kw),
                           f"kernel_attention__1__{window}")(q, k, v)

    def chunked(r, k, v, logw, u, state, chunk):
        return _kernel_jit(lambda *x: wkv(*x, chunk), f"kernel_wkv__{chunk}")(
            r, k, v, logw, u, state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "flash_attention", attention)
        mp.setattr(jattn, "flash_attention_banded", banded)
        mp.setattr(jrwkv, "wkv_chunked", chunked)
        yield


def _kernel_flops(name: str, avals) -> int:
    kind, *args = name.split("__")
    if kind == "kernel_attention":
        B, H_, Sq, D = avals[0].shape
        window = None if args[1] == "None" else int(args[1])
        return opcount.attention_flops(B, H_, Sq, avals[1].shape[2], D,
                                       causal=bool(int(args[0])), window=window)
    B, T, H_, K = avals[0].shape
    return opcount.wkv_flops(B * H_, T, K, avals[2].shape[-1], int(args[0]))


def _jaxpr_flops(jaxpr) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            free = math.prod(d for i, d in enumerate(rhs) if i not in rc and i not in rb)
            total += 2 * math.prod(lhs) * free
            continue
        if prim in ("jit", "pjit") and eqn.params["name"].startswith("kernel_"):
            total += _kernel_flops(eqn.params["name"], [v.aval for v in eqn.invars])
            continue
        assert prim not in ("while", "cond"), prim        # no trip count to read
        times = eqn.params["length"] if prim == "scan" else 1
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (tuple, list)) else (val,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += times * _jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += times * _jaxpr_flops(sub)
    return total


def _jax_step_flops(arch: str, shape_name: str) -> int:
    cfg = jreduced(jget(arch))
    shape = jbase.reduced_shape(jbase.SHAPES_BY_NAME[shape_name])
    p, b = jspecs.param_specs(cfg), jspecs.input_specs(cfg, shape)
    if shape.kind == "prefill":
        closed = jax.make_jaxpr(j_build_prefill_step(cfg, decode_len=shape.seq_len))(p, b)
    else:
        closed = jax.make_jaxpr(j_build_decode_step(cfg))(p, jspecs.cache_specs(cfg, shape), b)
    live, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return _jaxpr_flops(live)


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_serving_flops_equal_the_jax_jaxpr(arch, shape_name, named_kernels):
    cfg, shape = _cell(arch, shape_name)
    got = dryrun.trace(cfg, shape, _meta_mesh())["cost_analysis"]["flops"]
    assert got == _jax_step_flops(arch, shape_name)


# ---------------------------------------------------------------------------
# A rank's share
# ---------------------------------------------------------------------------


def _flops(cfg, shape, mesh_shape=(1, 1), coords=None, profile="2d"):
    return dryrun.trace(cfg, shape, _meta_mesh(mesh_shape, coords),
                        profile=profile)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-1.6b"])
def test_a_rank_counts_half_the_flops(arch, shape_name):
    """(2, 1) under '2d' splits the rows: each rank counts half of the
    unsharded FLOPs, kernels included.  (1, 2) under 'tp' splits heads,
    d_ff and vocabulary: half again for h2o; RWKV-6's token-shift and
    decay LoRA products stay replicated ('embed' x a LoRA rank on no TP
    axis, as the reference lays them out), so a rank counts half plus half
    of those (forward, remat's recompute and two backward products in a
    train step), and its WKV kernel exactly half."""
    cfg, shape = _cell(arch, shape_name)
    one = _flops(cfg, shape)
    for ms, profile in (((2, 1), "2d"), ((1, 2), "tp")):
        for c in range(2):
            coords = {"data": c if ms[0] == 2 else 0, "model": c if ms[1] == 2 else 0}
            rank = _flops(cfg, shape, ms, coords, profile)
            replicated = 0
            if arch == "rwkv6-1.6b" and profile == "tp":
                B, T, D = shape.global_batch, shape.seq_len, cfg.d_model
                per_pass = 2 * B * T * cfg.num_layers * D * (
                    10 * trwkv.LORA_MIX + trwkv.LORA_DECAY)
                replicated = per_pass * (4 if shape.kind == "train" else 1)
            assert 2 * rank["cost_analysis"]["flops"] == \
                one["cost_analysis"]["flops"] + replicated, (ms, profile, c)
            for name, k in one["kernels"].items():
                assert 2 * rank["kernels"][name]["flops"] == k["flops"], name


# ---------------------------------------------------------------------------
# Argument and output bytes against JAX's memory_analysis()
# ---------------------------------------------------------------------------

MEMORY_CELLS = [(a, s, p) for a in ("h2o-danube-1.8b", "rwkv6-1.6b", "qwen2-moe-a2.7b")
                for s, p in (("train_4k", "2d"), ("prefill_32k", "tp"),
                             ("decode_32k", "tp"))] + [
    (a, s, "cp") for a in ("h2o-danube-1.8b", "rwkv6-1.6b")
    for s in ("prefill_32k", "decode_32k")]

_JAX_MEMORY = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES_BY_NAME, get_config, reduced
from repro.configs.base import reduced_shape
from repro.launch.specs import cache_specs, input_specs, param_specs
from repro.models import actshard, get_module
from repro.optim import AdamWState, warmup_cosine
from repro.runtime import (batch_pspecs, cache_pspecs, model_param_pspecs,
                           build_decode_step, build_prefill_step, build_train_step)

def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))

# the reference dry-run's jit of each step (repro/launch/dryrun.py's
# lower_cell) on a (2, 2) mesh of forced CPU devices
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch, sname, profile in json.loads(sys.argv[1]):
    cfg = reduced(get_config(arch))
    shape = reduced_shape(SHAPES_BY_NAME[sname])
    actshard.set_mesh(mesh, profile)
    pspecs = model_param_pspecs(cfg, mesh, get_module(cfg).param_defs(cfg),
                                profile=profile)
    p_struct, b_struct = param_specs(cfg), input_specs(cfg, shape)
    b_pspecs = batch_pspecs(cfg, mesh, b_struct, profile)
    if shape.kind == "train":
        step = build_train_step(cfg, lr_schedule=warmup_cosine(3e-4, 100, 10_000))
        opt = AdamWState(count=jax.ShapeDtypeStruct((), jnp.int32), m=p_struct, v=p_struct)
        opt_ps = AdamWState(count=P(), m=pspecs, v=pspecs)
        outs = jax.eval_shape(step, p_struct, opt, b_struct)
        jitted = jax.jit(step, in_shardings=(named(mesh, pspecs), named(mesh, opt_ps),
                                             named(mesh, b_pspecs)),
                         out_shardings=(named(mesh, pspecs), named(mesh, opt_ps),
                                        named(mesh, jax.tree.map(lambda _: P(), outs[2]))),
                         donate_argnums=(0, 1))
        args = (p_struct, opt, b_struct)
    elif shape.kind == "prefill":
        step = build_prefill_step(cfg, decode_len=shape.seq_len)
        outs = jax.eval_shape(step, p_struct, b_struct)
        hid = P(b_pspecs[next(iter(b_pspecs))][0], None)
        jitted = jax.jit(step, in_shardings=(named(mesh, pspecs), named(mesh, b_pspecs)),
                         out_shardings=named(mesh, (hid, cache_pspecs(cfg, mesh, outs[1],
                                                                      profile))))
        args = (p_struct, b_struct)
    else:
        step = build_decode_step(cfg)
        c_struct = cache_specs(cfg, shape)
        c_ps = cache_pspecs(cfg, mesh, c_struct, profile)
        tok = b_pspecs["tokens"][0]
        outs = jax.eval_shape(step, p_struct, c_struct, b_struct)
        logits = P(tok, "model" if profile != "fsdp" else None)
        jitted = jax.jit(step, in_shardings=(named(mesh, pspecs), named(mesh, c_ps),
                                             named(mesh, b_pspecs)),
                         out_shardings=named(mesh, (P(tok), logits, c_ps)),
                         donate_argnums=(1,))
        args = (p_struct, c_struct, b_struct)
    ma = jitted.lower(*args).compile().memory_analysis()
    out[f"{arch} {sname} {profile}"] = dict(
        argument_bytes=ma.argument_size_in_bytes, output_bytes=ma.output_size_in_bytes,
        alias_bytes=ma.alias_size_in_bytes, output_leaves=len(jax.tree.leaves(outs)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_memory():
    env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_MEMORY, json.dumps(MEMORY_CELLS)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape_name,profile", MEMORY_CELLS)
def test_argument_and_output_bytes_equal_memory_analysis(arch, shape_name, profile,
                                                         jax_memory):
    cfg, shape = _cell(arch, shape_name)
    got = dryrun.trace(cfg, shape, _meta_mesh((2, 2)), profile=profile)["memory_analysis"]
    want = jax_memory[f"{arch} {shape_name} {profile}"]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["output_bytes"] == want["output_bytes"] - 8 * want["output_leaves"]
    assert got["alias_bytes"] == want["alias_bytes"]


# ---------------------------------------------------------------------------
# The meta trace against real runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-1.6b", "qwen2-moe-a2.7b"])
def test_meta_trace_counts_equal_a_real_cpu_run(arch, shape_name):
    cfg, shape = _cell(arch, shape_name)
    meta = dryrun.trace(cfg, shape, _meta_mesh())
    real = dryrun.trace(cfg, shape, mesh_lib.abstract_mesh((1, 1), AXES,
                                                           {"data": 0, "model": 0}))
    for key in ("cost_analysis", "kernels", "collectives"):
        assert real[key] == meta[key], key
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert real["memory_analysis"][key] == meta["memory_analysis"][key], key
    assert bool(meta["kernels"]) == (shape.kind != "decode")    # decode runs no kernel


WORLD_RUNS = [("h2o-danube-1.8b", "train_4k", "2d"), ("rwkv6-1.6b", "train_4k", "2d"),
              ("qwen2-moe-a2.7b", "train_4k", "2d"), ("rwkv6-1.6b", "train_4k", "cp"),
              ("h2o-danube-1.8b", "prefill_32k", "tp"), ("h2o-danube-1.8b", "decode_32k", "tp"),
              ("h2o-danube-1.8b", "prefill_32k", "cp"), ("rwkv6-1.6b", "prefill_32k", "cp")]


def _world_rank(runs):
    """A rank of a (2, 2) gloo world: each run's real collectives record
    and FLOPs, and its meta trace's at the rank's coordinates."""
    mesh = mesh_lib.make_mesh((2, 2), AXES, device="cpu")
    meta = mesh_lib.abstract_mesh((2, 2), AXES, mesh.coords, device="meta")
    out = {}
    for arch, shape_name, profile in runs:
        cfg, shape = _cell(arch, shape_name)
        a = dryrun.trace(cfg, shape, mesh, profile=profile)
        b = dryrun.trace(cfg, shape, meta, profile=profile)
        out[f"{arch} {shape_name} {profile}"] = dict(
            real=a["collectives"], meta=b["collectives"],
            real_flops=a["cost_analysis"]["flops"], meta_flops=b["cost_analysis"]["flops"])
    return mesh.coords, out


@pytest.fixture(scope="module")
def world_records():
    return mesh_lib.spawn_local(4, _world_rank, WORLD_RUNS, device="cpu",
                                timeout_s=WORLD_S)


@pytest.mark.parametrize("run", [" ".join(r) for r in WORLD_RUNS])
def test_meta_collectives_equal_a_gloo_world(run, world_records):
    for coords, runs in world_records:
        got = runs[run]
        assert got["real"], (coords, "no collective recorded")
        assert got["meta"] == got["real"], coords
        assert got["meta_flops"] == got["real_flops"], coords
    kinds = set(world_records[0][1][run]["real"])
    if run.endswith("train_4k 2d"):
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    if run.endswith("train_4k cp") or run.startswith("rwkv6-1.6b prefill_32k cp"):
        assert "collective-permute" in kinds
    if run.endswith("prefill_32k cp"):           # the last hidden from the last rank
        assert "all-reduce" in kinds


# ---------------------------------------------------------------------------
# Records, refusals and routes
# ---------------------------------------------------------------------------


def test_the_reference_single_cell():
    """``tests/test_dryrun_cell.py``'s cell: olmo-1b decode_32k under 'tp'
    with bf16 weights on the 16 x 16 mesh."""
    rec = dryrun.analyse_cell("olmo-1b", "decode_32k", multi_pod=False, profile="tp",
                              serve_bf16=True)
    assert rec["corrected"]["trip_count"] == 16
    assert rec["corrected"]["flops"] > 0
    assert rec["collectives"] and rec["collective_wire_bytes"] > 0
    assert 0 < rec["memory_analysis"]["argument_bytes"] < H.HBM_BYTES
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode" and rec["ranks"] == [
        {"data": 0, "model": 0}]
    assert not any(k.startswith("u2_") for k in rec) and "trace_s" in rec


def test_cli_writes_a_record_then_skips_it(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    argv = ["dryrun", "--arch", "rwkv6-1.6b", "--shape", "long_500k", "--multi-pod",
            "--tag", "t"]
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main()
        dryrun.main()
    path = tmp_path / "rwkv6-1.6b__long_500k__pod2-t.json"
    rec = json.loads(path.read_text())
    assert rec["mesh"] == "2x16x16" and rec["tag"] == "t"
    assert set(rec["corrected"]) == {"flops", "bytes accessed", "transcendentals",
                                     "collective_wire_bytes", "trip_count"}
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
    assert "skip rwkv6-1.6b__long_500k__pod2-t.json (exists)" in buf.getvalue()
    assert dryrun.ARTIFACT_DIR.name != "dryrun"


def test_cp_counts_the_last_rank_of_model_too():
    rec = dryrun.analyse_cell("rwkv6-1.6b", "train_4k", multi_pod=False, profile="cp")
    assert rec["ranks"] == [{"data": 0, "model": 0}, {"data": 0, "model": 15}]
    assert "collective-permute" in rec["collectives"]
    assert all(v in rec["ranks"] for v in rec["rank_of"].values())


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_cp_serving_cells_count_rank_0_and_the_last_rank(shape_name):
    """h2o's 'cp' serving cells on 16 x 16: rank 0's program and the last
    rank of 'model''s are both counted.  A prefill rank holds 2 rows of 2048
    of the 32768 positions: beside the FSDP gathers over 'data' it gathers
    K / V over 'model' a layer, and takes the last hidden state from the
    last rank (one all-reduce of its [2, 2560] bf16 block); the last rank's
    attention reads every key, so its FLOPs are the record's.  A decode
    step's token is whole on every rank of 'model': it attends its 2048
    slots of each layer's cache and merges the softmaxes over 'model' (a
    max and a sum a layer), the same program on both ranks."""
    rec = dryrun.analyse_cell("h2o-danube-1.8b", shape_name, multi_pod=False,
                              profile="cp")
    assert rec["ranks"] == [{"data": 0, "model": 0}, {"data": 0, "model": 15}]
    reduce = rec["collectives"]["all-reduce"]
    if shape_name == "prefill_32k":
        assert (reduce["count"], reduce["result_bytes"]) == (1, 2 * 2560 * 2)
        assert rec["rank_of"]["cost_analysis.flops"] == {"data": 0, "model": 15}
        assert rec["kernels"]["flash_attention"]["calls"] == 24
    else:
        assert reduce["count"] == 2 * 24 and not rec["rank_of"]
        assert not rec["kernels"]


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-1.6b"])
def test_cp_prefill_ranks_sum_to_the_unsharded_flops(arch):
    """The reduced prefill_32k cell (2 x 64) on a (1, 2) meta mesh under
    'cp': the two ranks' aten product FLOPs sum exactly to the unsharded
    program's, and so do their kernels' (RWKV-6's ``wkv_chunked``: 32
    tokens a rank from a handed-on state; h2o's causal ``flash_attention``
    over its window of 32: rank r counts ``opcount.attention_flops(2, H,
    32, 32 (r + 1), D, causal=True, window=32, q_offset=32 r)`` a layer,
    and the two sum to the unsharded 64 x 64 count, the pairs no mask
    removes).  Rank 1 also takes the last hidden state and, for RWKV-6,
    hands rank 0 its half of every state and token shift."""
    cfg, shape = _cell(arch, "prefill_32k")
    one = _flops(cfg, shape)
    ranks = [_flops(cfg, shape, (1, 2), {"data": 0, "model": r}, "cp") for r in range(2)]

    def aten(rec):
        return rec["cost_analysis"]["flops"] - sum(k["flops"] for k in rec["kernels"].values())

    assert sum(aten(r) for r in ranks) == aten(one)
    for name, k in one["kernels"].items():
        assert sum(r["kernels"][name]["flops"] for r in ranks) == k["flops"], name
    if arch == "h2o-danube-1.8b":
        S, H, D = shape.seq_len // 2, cfg.num_heads, cfg.head_dim
        for r, rec in enumerate(ranks):
            assert rec["kernels"]["flash_attention"]["flops"] == cfg.num_layers * \
                opcount.attention_flops(shape.global_batch, H, S, S * (r + 1), D,
                                        causal=True, window=cfg.window, q_offset=S * r)
    else:
        permutes = [r["collectives"]["collective-permute"]["count"] for r in ranks]
        # a layer: the WKV state handed on, two token shifts, three blocks of
        # what rank 1 leaves (state, shift_tm, shift_cm) sent to rank 0
        assert permutes == [cfg.num_layers * 6] * 2


def _meta(*tensors):
    return [None if t is None else t.detach().to("meta").requires_grad_(t.requires_grad)
            for t in tensors]


def _routes(fn, *tensors):
    """(shapes and dtypes of fn's outputs on CPU tensors, on meta ones)."""
    def sig(out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return [None if o is None else (tuple(o.shape), o.dtype) for o in outs]
    return sig(fn(*tensors)), sig(fn(*_meta(*tensors)))


def _randn(*shape, grad=False):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0)) \
        .requires_grad_(grad)


@pytest.mark.parametrize("name", ["fused_ibn", "matmul_ln", "depthwise_conv2d",
                                  "flash_attention", "wkv_chunked"])
def test_meta_route_returns_the_cpu_route_shapes(name):
    with torch.no_grad():
        if name == "fused_ibn":
            cpu, meta = _routes(lambda x, a, b, g: ops.fused_ibn(x, a, b, g),
                                _randn(2, 5, 8), _randn(8, 16), _randn(16, 6),
                                _randn(8, 16))
        elif name == "matmul_ln":
            cpu, meta = _routes(ops.matmul_ln, _randn(10, 8), _randn(8, 12),
                                _randn(12), _randn(12), _randn(12))
        elif name == "depthwise_conv2d":
            cpu, meta = _routes(ops.depthwise_conv2d, _randn(2, 6, 6, 4),
                                _randn(3, 3, 4), _randn(4))
        elif name == "flash_attention":
            cpu, meta = _routes(lambda q, k, v: ops.flash_attention(q, k, v, window=3),
                                _randn(1, 2, 9, 8), _randn(1, 2, 9, 8), _randn(1, 2, 9, 8))
        else:
            cpu, meta = _routes(lambda r, k, v, w, u, s: ops.wkv_chunked(
                r, k, v, w, u, chunk=4, state=s), _randn(2, 9, 4), _randn(2, 9, 4),
                _randn(2, 9, 6), -_randn(2, 9, 4).exp(), _randn(2, 4), _randn(2, 4, 6))
    assert cpu == meta


@pytest.mark.parametrize("name", ["flash_attention", "wkv_chunked"])
def test_meta_backward_returns_the_cpu_route_gradients(name):
    def grads(*leaves):
        if name == "flash_attention":
            out = ops.flash_attention(*leaves, causal=True)
            gs = torch.autograd.grad(out.float().sum(), leaves)
        else:
            out, state = ops.wkv_chunked(*leaves[:5], chunk=4, state=leaves[5])
            gs = torch.autograd.grad(out.sum() + state.sum(), leaves)
        return gs

    if name == "flash_attention":
        leaves = [_randn(1, 2, 7, 8, grad=True) for _ in range(3)]
    else:
        leaves = [_randn(2, 9, 4, grad=True), _randn(2, 9, 4, grad=True),
                  _randn(2, 9, 6, grad=True), (-_randn(2, 9, 4).exp()).requires_grad_(),
                  _randn(2, 4, grad=True), _randn(2, 4, 6, grad=True)]
    cpu, meta = _routes(grads, *leaves)
    assert cpu == meta
    with opcount.OpCounter() as c_cpu:
        grads(*leaves)
    with opcount.OpCounter() as c_meta:
        grads(*_meta(*leaves))
    assert c_cpu.kernels() == c_meta.kernels()
    assert {name, f"{name}_bwd"} <= set(c_meta.kernels())


# ---------------------------------------------------------------------------
# The counter itself
# ---------------------------------------------------------------------------


def test_counter_flops_equal_flop_counter_mode_on_a_plain_step():
    """With no kernel (``ref.PLAIN``) every FLOP is an aten product, which
    ``FlopCounterMode`` counts too."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg, shape = _cell("h2o-danube-1.8b", "train_4k")
    step, args, donated, batch_bytes = dryrun.build_cell(
        cfg, shape, mesh_lib.abstract_mesh((1, 1), AXES, {"data": 0, "model": 0}))
    from repro_torch.optim import warmup_cosine
    from repro_torch.runtime import build_train_step
    plain = build_train_step(cfg, lr_schedule=warmup_cosine(3e-4, 100, 10_000),
                             kernels=ref.PLAIN)
    with FlopCounterMode(display=False) as fc, opcount.OpCounter() as c:
        plain(*args)
    assert c.flops == fc.get_total_flops() > 0
    assert not c.kernels()


def test_counter_formulas_and_peak():
    assert opcount.unmasked_pairs(4, 4, True, None) == 10
    assert opcount.unmasked_pairs(4, 8, True, 2, q_offset=4) == 8
    assert opcount.attention_flops(1, 2, 4, 4, 8, causal=False, window=None) == 4 * 8 * 2 * 16
    from repro_torch.core.workload import SCAN, Layer, scan_macs
    assert opcount.wkv_flops(3, 10, 4, 5, 64) == 2 * scan_macs(
        Layer("w", SCAN, b=3, ox=10, c=4, k=5), 10)
    assert opcount.wkv_bwd_flops(3, 10, 4, 5, 4) == 2 * 3 * 10 * (4 * 4 * 5 + 4 * (12 + 10))
    x = torch.empty(1000, device="meta")
    with opcount.OpCounter() as c:
        c.hold(x)
        y = x * 2                   # 4000 bytes live
        z = y + 1                   # 8000
        del y
        w = z.view(10, 100) * 3     # a view is free; 8000 again
    assert c.held_bytes == 4000 and c.peak_bytes == 12000
    assert c.bytes_accessed == 3 * 8000 and c.read(x) and not c.read(w)
    assert c.by_name["aten.mul"]["calls"] == 2 and c.by_name["aten.view"]["bytes accessed"] == 0
