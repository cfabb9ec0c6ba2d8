"""Where a call of the attention backward spends its time, and what its
``PLAN`` rests on.

    python -m repro_torch.profile_flash_attention_bwd [--out FILE.json] [--source PATH ...]
    PYTHONPATH=OTHER/src python src/repro_torch/profile_flash_attention_bwd.py --ops

Needs one CUDA device and ``nvcc``.  At the five trained shapes (SHAPES:
h2o-danube's 4 x 32 x 512 x 80 causal with K / V on 8 heads repeated over
32, olmo-1b's D 128, Seamless's D 64 non-causal and its cross-attention
256 -> 512, RecurrentGemma's MQA D 256 under its window of 2048; bfloat16),
and at a float32 4 x 16 x 512 x 64 causal (the float32 rows of PLAN),
it times every variant of ``kernels.flash_attention_bwd.PLAN`` that the
sweep covers: 64 or 128 keys a dK / dV block, times 2 or 3 stages of the
``cp.async`` ring.  Each variant is a copy of
``csrc/flash_attention_bwd.cu`` whose PLAN rows take those keys and stages
wherever their shared memory fits (the other rows keep theirs), built
under ``build/profile_flash_attention_bwd/<variant>/``; the library the
port loads is not touched.  Each ``--source`` (it may be given more than
once) is one more copy, that file (the parent's kernel, say: ``git show
HEAD~1:src/repro_torch/kernels/csrc/flash_attention_bwd.cu >
build/parent_bwd.cu``), built and timed beside them in the same rounds.
For each variant at each shape:

- it is first checked against autograd of the plain ``ref.attention_ref``
  on the same inputs (2e-2 (1 + |b|) bf16, 2e-3 float32);
- a call's device time by CUDA events, the L2 cache flushed before each
  call, in ROUNDS rounds that take the variants in turns (the order
  reversed every other round), each round's number the median of REPS
  calls: the median, least and most over the rounds (``chip_smoke.py``
  times the plain version and SDPA's backward beside the port's);
- each of the call's three kernels (delta, dkv, dq) by ``torch.profiler``;
- the registers and spill bytes ``ptxas`` gave the instance's dK / dV and
  dQ kernels.

``<- plan`` marks the variant whose instance the port's PLAN gives the
shape.  A variant whose instance at a shape is the same as an earlier
one's (its shared memory did not fit that row) is not timed again there.

``--ops`` times only the wrapper ``flash_attention_bwd.flash_attention_bwd``
(given the forward's out and lse) at SHAPES, ROUNDS medians of REPS calls,
checked as above: run as a file with another checkout's ``src`` first on
PYTHONPATH, it times that checkout's kernel (one whose C entry takes other
arguments than this one's, which ``--source`` cannot load), so that two
versions are compared in one call on one card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb

# name, (B, H, Sq, Sk, D, causal, window, KV heads or None), dtype
SHAPES = (
    ("h2o", (4, 32, 512, 512, 80, True, None, 8), torch.bfloat16),
    ("olmo", (4, 16, 512, 512, 128, True, None, None), torch.bfloat16),
    ("seamless", (4, 16, 512, 512, 64, False, None, None), torch.bfloat16),
    ("seamless_cross", (4, 16, 256, 512, 64, False, None, None), torch.bfloat16),
    ("rg", (4, 10, 512, 512, 256, True, 2048, 1), torch.bfloat16),
    ("float32", (4, 16, 512, 512, 64, True, None, None), torch.float32),
)
KEYS = (64, 128)
STAGES = (2, 3)
ROUNDS = 6
REPS = 5
CALLS = 5
KINDS = ("delta", "dkv", "dq")
BUILD = Path(__file__).resolve().parents[2] / "build" / "profile_flash_attention_bwd"
_ROW = re.compile(r"\{(\d+), (\d+), (\d+), (\d+), (\d+)\}")


def plan_rows(src: str) -> list[tuple[int, int, int, int, int]]:
    """The rows of the PLAN table in a kernel source: (dtype, d_max, keys,
    stages, chunk), dtype 0 float32 and 1 bfloat16."""
    body = src[src.index("constexpr PlanRow PLAN[] = {"):]
    body = body[:body.index("};")]
    return [tuple(int(x) for x in m) for m in _ROW.findall(body)]


def _fits(row, keys: int, stages: int) -> bool:
    dtype, d_max, _, _, chunk = row
    torch_dtype = torch.float32 if dtype == 0 else torch.bfloat16
    sm = fb.smem_bytes(d_max, torch_dtype, keys=keys, stages=stages, chunk=chunk)
    return max(sm.values()) <= fb.SMEM_BYTES


def variant_source(keys: int, stages: int) -> tuple[str, list]:
    """csrc/flash_attention_bwd.cu with every PLAN row whose shared memory
    fits set to ``keys`` and ``stages`` -> (the source, its rows)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    rows = []
    for row in plan_rows(src):
        dtype, d_max, _, _, chunk = row
        new = (dtype, d_max, keys, stages, chunk) if _fits(row, keys, stages) else row
        rows.append(new)
        old_text = "{" + ", ".join(str(x) for x in row) + "}"
        new_text = "{" + ", ".join(str(x) for x in new) + "}"
        if src.count(old_text) != 1:
            raise RuntimeError(f"profile_flash_attention_bwd: PLAN row {old_text} is "
                               "not once in the kernel")
        src = src.replace(old_text, new_text)
    return src, rows


def _effective(rows, D: int, dtype: torch.dtype):
    """The (keys, stages, chunk) a head of D takes under ``rows``."""
    code = 1 if dtype == torch.bfloat16 else 0
    row = min((r for r in rows if r[0] == code and r[1] >= D), key=lambda r: r[1])
    return row[2], row[3], row[4]


def build(variants: dict) -> dict:
    """Compiles each source (name -> text) into its own library under
    BUILD, all ``nvcc`` processes at once -> name -> (the C entry, the
    ptxas log)."""
    procs = {}
    for name, src in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_attention_bwd.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
               str(out / "libbwd.so"), str(out / "flash_attention_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"profile_flash_attention_bwd: nvcc failed for {name}\n{log}")
        fn = ctypes.CDLL(str(BUILD / name / "libbwd.so")).repro_flash_attention_bwd
        fn.argtypes, fn.restype = fb._ARGTYPES, ctypes.c_int
        libs[name] = (fn, log)
    return libs


@contextlib.contextmanager
def using(fn):
    """``flash_attention_bwd`` launching ``fn`` (a variant's C entry)."""
    real = fb._kernel
    fb._kernel = lambda: fn
    try:
        yield
    finally:
        fb._kernel = real


def inputs(B, H, Sq, Sk, D, causal, window, hk, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    hk = hk or H

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    q = randn(B, H, Sq, D)
    k = randn(B, hk, Sk, D).repeat_interleave(H // hk, dim=1)
    v = randn(B, hk, Sk, D).repeat_interleave(H // hk, dim=1)
    dout = randn(B, H, Sq, D)
    return q, k, v, dout, dict(causal=causal, window=window)


def check(got, want) -> float:
    err, tol = 0.0, 2e-3 if want[0].dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        if not (torch.isfinite(g).all() and bool((d <= tol + tol * w.abs()).all())):
            raise RuntimeError(f"profile_flash_attention_bwd: a variant disagrees with "
                               f"autograd of attention_ref (max {d.max().item():.3e})")
        err = max(err, d.max().item())
    return err


def event_ms(fn, flush: torch.Tensor) -> float:
    """Median device ms of REPS calls, the L2 flushed before each."""
    fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, flush: torch.Tensor) -> dict:
    """Mean device ms a call of each of the three kernels, by
    ``torch.profiler``, the L2 flushed before each call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        for kind in KINDS:
            if us and f"attn_bwd_{kind}_kernel" in ev.key:
                out[kind] = out.get(kind, 0.0) + us / 1e3 / CALLS
    return out


def shape_run(name, shape, dtype, libs, rows, flush) -> dict:
    B, H, Sq, Sk, D, causal, window, hk = shape
    q, k, v, dout, kw = inputs(*shape, dtype)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, dout)
    plan = fb.instance(D, q.dtype)
    forms, recs, seen = {}, {}, {}
    for var, (fn, log) in libs.items():
        eff = _effective(rows[var], D, q.dtype) if var in rows else None
        if eff is not None and eff in seen:
            recs[var] = dict(same_as=seen[eff])
            continue
        if eff is not None:
            seen[eff] = var

        def call(fn=fn):
            with using(fn):
                return fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

        err = check(call(), want)
        inst = dict(chunk=eff[2], keys=eff[0], stages=eff[1], dtype=plan["dtype"],
                    fixed_chunks=plan["fixed_chunks"]) if eff else None
        recs[var] = dict(instance=eff, max_abs_err=err,
                         ptxas=fb.ptxas_of(inst, log) if inst else fb.ptxas(log),
                         plan=eff == (plan["keys"], plan["stages"], plan["chunk"]),
                         kernel_ms=kernel_ms(call, flush), rounds=[])
        forms[var] = call
    names = list(forms)
    for r in range(ROUNDS):
        for var in (names if r % 2 == 0 else names[::-1]):
            recs[var]["rounds"].append(event_ms(forms[var], flush))
    for var in names:
        t = recs[var]["rounds"]
        recs[var].update(ms=statistics.median(t), ms_min=min(t), ms_max=max(t))
    return dict(name=name, shape=list(shape[:5]), causal=causal, window=window, kv_heads=hk,
                dtype=plan["dtype"], plan=plan, variants=recs)


def ops_times(flush: torch.Tensor) -> list[dict]:
    """The wrapper of the package on the path at SHAPES: ms (the median of
    ROUNDS rounds of REPS calls) and the max error against autograd of
    ``ref.attention_ref``."""
    rows = []
    for name, shape, dtype in SHAPES:
        q, k, v, dout, kw = inputs(*shape, dtype)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, dout)

        def call():
            return fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

        err = check(call(), want)
        ms = statistics.median(event_ms(call, flush) for _ in range(ROUNDS))
        rows.append(dict(name=name, shape=list(shape[:5]), dtype=str(dtype).split(".")[-1],
                         ms=ms, max_abs_err=err))
        print(f"ops flash_attention_bwd {name}: {ms:.4f} ms, err {err:.2e}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--source", action="append", default=[],
                    help="one more kernel source to build and time beside the variants "
                         "(the parent's, say); may be given more than once")
    ap.add_argument("--ops", action="store_true",
                    help="time only the wrapper of the package on the path at SHAPES")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash_attention_bwd: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"device {smi}")
    if a.ops:
        _build.library()
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
        print(f"ops: the package at {Path(_build.__file__).parents[2]}", flush=True)
        rows = ops_times(flush)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            Path(a.out).write_text(json.dumps(dict(
                device=smi, package=str(Path(_build.__file__).parents[2]), ops=rows),
                indent=1))
        return
    sources, rows = {}, {}
    for keys in KEYS:
        for stages in STAGES:
            name = f"k{keys}_s{stages}"
            sources[name], rows[name] = variant_source(keys, stages)
    for path in a.source:
        sources[f"source_{Path(path).stem}"] = Path(path).read_text()
    libs = build(sources)
    for name, (_, log) in libs.items():
        for inst, (regs, st, ld) in fb.ptxas(log).items():
            print(f"ptxas {name} {inst}: {regs} registers, spill {st} / {ld} bytes")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    results = []
    for name, shape, dtype in SHAPES:
        rec = shape_run(name, shape, dtype, libs, rows, flush)
        results.append(rec)
        B, H, Sq, Sk, D = shape[:5]
        print(f"bwd {name} {B}x{H}x{Sq}x{Sk}x{D} causal={shape[5]} window={shape[6]} "
              f"{rec['dtype']}: "
              f"plan keys {rec['plan']['keys']} stages {rec['plan']['stages']} "
              f"chunk {rec['plan']['chunk']}")
        for var, r in rec["variants"].items():
            if "same_as" in r:
                print(f"  {var}: the instance of {r['same_as']}")
                continue
            line = (f"  {var}{' <- plan' if r.get('plan') else ''}: ms {r['ms']:.4f} "
                    f"({r['ms_min']:.4f}..{r['ms_max']:.4f})")
            if "kernel_ms" in r:
                line += " | " + ", ".join(f"{k} {r['kernel_ms'].get(k, 0.0):.4f}"
                                          for k in KINDS)
                line += f" | err {r['max_abs_err']:.2e} | ptxas {r['ptxas']}"
            print(line, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(dict(device=smi, shapes=results), indent=1))


if __name__ == "__main__":
    main()
