"""Where a call of the WKV backward kernel spends its time.

    python -m repro_torch.profile_wkv_bwd [--out FILE.json] [--source PATH ...]
    PYTHONPATH=OTHER/src python src/repro_torch/profile_wkv_bwd.py --ops

Needs one CUDA device and ``nvcc``.  At RWKV-6's trained shape (B*H =
4*32, T = 512, K = V = 64, chunk 64, bfloat16 r/k/v/dout, float32 logw
and u), at the B = 1 x 200 prompt (32 x 200, chunk 64) and at chunk 128
(the tile instance of ``kernels.rwkv_chunk_bwd.plan``), it builds
``csrc/wkv_chunked_bwd.cu`` as it is and, with ``clock64`` stamps, a copy
of it, each under ``build/profile_wkv_bwd/<name>/`` (the library the port
loads is not touched).  Each ``--source`` (it may be given more than
once) is one more copy, that file (the parent's kernel, say: ``git show
HEAD~1:src/repro_torch/kernels/csrc/wkv_chunked_bwd.cu >
build/parent_wkv_bwd.cu``), built beside it; a source whose C entry has
only the tile instance is called with the tile instance's partials.  For
each source at each shape:

- it is first checked against autograd of the plain ``ref.wkv_ref`` on
  the same inputs (a relative L2 error below 1e-2 on every gradient);
- a call's device time by CUDA events, the L2 cache flushed before each
  call, in ROUNDS rounds that take the sources in turns (the order
  reversed every other round), each round's number the median of REPS
  calls: the median, least and most over the rounds;
- each of the call's three kernels (the reverse states pass, the
  gradients pass, the finishing pass) by ``torch.profiler``, the mean
  device time over CALLS calls, warm L2, beside the forward kernel's two
  passes on the same inputs;
- the registers and spill bytes ``ptxas`` gave its gradients-pass
  instances.

Then the phases of the chunk instance's gradients pass, from the stamped
copy: for the first warp of every group (one 16-row tile of a chunk), the
SM cycles from the block's start to the end of each of PHASES, cumulative
(loads landed, the cumsum, the tile's blocks dA and A and its Q, the
diagonal block, the chunk's states, the other tiles, dlogw's suffix,
stores); the median over the groups of each tile index (tile 0 visits the
three later tiles, tile 3 multiplies against the 48 earlier rows) and over
all groups.

``--ops`` times only the wrapper ``rwkv_chunk_bwd.wkv_chunked_bwd`` (given
the forward's workspace) at SHAPES, ROUNDS medians of REPS calls, checked
as above: run as a file with another checkout's ``src`` first on
PYTHONPATH, it times that checkout's kernel (one whose C entry takes other
arguments than this one's, which ``--source`` cannot load), so that two
versions are compared in one call on one card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv_chunk as wkv
from repro_torch.kernels import rwkv_chunk_bwd as wkv_bwd

SHAPES = ((128, 512, 64, 64, 64), (32, 200, 64, 64, 64), (32, 512, 64, 64, 128))
ROUNDS = 6
REPS = 5
CALLS = 10
PHASES = ("loads", "cumsum", "blocks", "diagonal", "states", "visits", "suffix", "stores")
KERNELS = ("wkv_states", "wkv_outputs", "wkv_rstates", "wkv_grads", "wkv_finish")
MAX_BLOCKS = 8192
GROUPS = 4
BUILD = Path(__file__).resolve().parents[2] / "build" / "profile_wkv_bwd"

# (anchor text in the chunk kernel, stamp slot, the stamp goes before the
# anchor): the end of each of PHASES but the last in
# ``wkv_grads_chunk_kernel``
_STAMPS = (
    ("    uf[kk] = kk < K ? load_any(u, bh * K + kk, u_code) : 0.f;\n  }\n"
     "  cp_async_wait<2>();\n  __syncthreads();\n", 0, False),
    ("  // b_prev of chunk row s is bz[s], b of row s bz[s + 1]; rho = b_prev of\n", 1, True),
    ("  __syncthreads();      // every tile's Q and blocks are in place\n", 2, False),
    ("    // 5. the chunk's states:", 3, True),
    ("    // 6. the other tiles.", 4, True),
    ("  // 7. dlogw within the chunk", 5, True),
    ("  // 8. dr, dk, dv with the u terms", 6, True),
)
_END = ("                 av[i][2 * h + 1] + rk * to_f32(dd[1]), V % 2 == 0, col + 1 < V);\n"
        "      }\n    }\n  }\n}\n")


def instrumented_source() -> str:
    """csrc/wkv_chunked_bwd.cu with the stamps in; raises if the kernel no
    longer has the text a stamp goes at."""
    src = (_build.CSRC / "wkv_chunked_bwd.cu").read_text()

    def once(anchor: str, new: str) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_wkv_bwd: the kernel changed near {anchor!r}")
        src = src.replace(anchor, new)

    once("constexpr unsigned FULL = 0xffffffffu;\n",
         "constexpr unsigned FULL = 0xffffffffu;\n"
         f"__device__ long long g_stamps[{MAX_BLOCKS} * {GROUPS} * 8];\n")
    start = ('  auto group_sync = [&]() { asm volatile("bar.sync %0, %1;" ::"r"(1 + J), '
             '"r"(GT) : "memory"); };\n')
    once(start, start + "  const long long t_start = clock64();\n  long long ph[8] = {};\n")
    for anchor, slot, before in _STAMPS:
        stamp = f"  ph[{slot}] = clock64() - t_start;\n"
        once(anchor, stamp + anchor if before else anchor + stamp)
    once(_END, _END[:-2] + "  ph[7] = clock64() - t_start;\n"
         "  const long long blk = blockIdx.x * (long long)gridDim.y + blockIdx.y;\n"
         f"  if (gt == 0 && blk < {MAX_BLOCKS})\n"
         f"    for (int i = 0; i < 8; ++i) g_stamps[(blk * {GROUPS} + J) * 8 + i] = ph[i];\n"
         "}\n")
    return src + ('\nextern "C" int repro_wkv_bwd_stamps(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n")


def build(sources: dict) -> dict:
    """Compiles each source (name -> text) into its own library under
    BUILD, all ``nvcc`` processes at once -> name -> (the library, the
    ptxas log)."""
    procs = {}
    for name, text in sources.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "wkv_chunked_bwd.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
               str(out / "libwkv_bwd.so"), str(out / "wkv_chunked_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"profile_wkv_bwd: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(str(BUILD / name / "libwkv_bwd.so"))
        lib.repro_wkv_chunked_bwd.argtypes = wkv_bwd._ARGTYPES
        lib.repro_wkv_chunked_bwd.restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def _tiles_plan(C, K, V, itemsize=4):
    """The tile instance's plan, for a source that has no other."""
    return dict(instance="tiles", smem=wkv_bwd.smem_bytes(C, K, V), parts=-(-C // wkv_bwd.TILE))


@contextlib.contextmanager
def using(lib, tiles_only: bool):
    """``wkv_chunked_bwd`` launching ``lib``'s C entry (with the tile
    instance's partials where ``tiles_only``)."""
    real = wkv_bwd._kernel, wkv_bwd.plan
    wkv_bwd._kernel = lambda: lib.repro_wkv_chunked_bwd
    if tiles_only:
        wkv_bwd.plan = _tiles_plan
    try:
        yield
    finally:
        wkv_bwd._kernel, wkv_bwd.plan = real


def inputs(BH, T, K, V, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    r, k = (0.5 * torch.randn(BH, T, K, device="cuda", generator=g) for _ in range(2))
    v = 0.5 * torch.randn(BH, T, V, device="cuda", generator=g)
    logw = -torch.exp(0.5 * torch.randn(BH, T, K, device="cuda", generator=g))
    u = 0.5 * torch.randn(BH, K, device="cuda", generator=g)
    dout = torch.randn(BH, T, V, device="cuda", generator=g)
    return (r.to(bf), k.to(bf), v.to(bf), logw, u), dout.to(bf)


def check(call, want) -> float:
    """The backward of ``call`` (given the forward's workspace) against
    autograd of ``wkv_ref``: the worst relative L2 error over the five
    gradients."""
    got = call()
    worst = max(((g.float() - w.float()).norm() / w.float().norm()).item()
                for g, w in zip(got, want))
    if not worst < 1e-2:
        raise RuntimeError(f"profile_wkv_bwd: the backward disagrees (rel L2 {worst:.3e})")
    return worst


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


def kernel_times(call, args, chunk) -> dict:
    """Mean device ms a call of each kernel of the forward and the
    backward, over CALLS calls (warm L2), by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            wkv.forward_with_states(*args, chunk=chunk)
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        for name in KERNELS:
            if us and f"{name}_" in ev.key:
                out[name] = out.get(name, 0.0) + us / 1e3 / CALLS
    return out


def shape_run(shape, libs, flush) -> dict:
    BH, T, K, V, chunk = shape
    args, dout = inputs(BH, T, K, V)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.wkv_ref(*plain)[0], plain, dout)
    _, _, ws = wkv.forward_with_states(*args, chunk=chunk)
    C = min(chunk, T)
    recs, calls = {}, {}
    for name, (lib, log) in libs.items():
        tiles_only = "wkv_grads_chunk_kernel" not in log

        def call(lib=lib, tiles_only=tiles_only):
            with using(lib, tiles_only):
                return wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)

        inst = "tiles" if tiles_only else wkv_bwd.plan(C, K, V, args[0].element_size())["instance"]
        recs[name] = dict(instance=inst, rel_l2=check(call, want),
                          kernel_ms=kernel_times(call, args, chunk), rounds=[])
        calls[name] = call
    names = list(calls)
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            recs[name]["rounds"].append(event_ms(calls[name], flush))
    for name in names:
        t = recs[name]["rounds"]
        recs[name].update(ms=statistics.median(t), ms_min=min(t), ms_max=max(t))
    return dict(shape=list(shape), sources=recs)


def phases(lib, shape) -> dict:
    """Cumulative SM cycles at the end of each of PHASES in the stamped
    chunk instance: medians by tile index and over every live group."""
    BH, T, K, V, chunk = shape
    args, dout = inputs(BH, T, K, V)
    _, _, ws = wkv.forward_with_states(*args, chunk=chunk)
    with using(lib, False):
        wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)
    torch.cuda.synchronize()
    host = np.zeros(MAX_BLOCKS * GROUPS * 8, np.int64)
    if lib.repro_wkv_bwd_stamps(host.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("profile_wkv_bwd: reading the stamps failed")
    n_blocks = min(MAX_BLOCKS, BH * -(-T // min(chunk, T)))
    st = host.reshape(MAX_BLOCKS, GROUPS, 8)[:n_blocks]
    by_tile, live_all = {}, []
    for J in range(GROUPS):
        rows = st[:, J][st[:, J, -1] > 0]     # groups past T write no stamps
        if len(rows):
            by_tile[J] = dict(zip(PHASES, np.median(rows, 0).astype(int).tolist()))
            live_all.append(rows)
    rows = np.concatenate(live_all)
    return dict(by_tile=by_tile, all=dict(zip(PHASES, np.median(rows, 0).astype(int).tolist())),
                groups=int(len(rows)))


def ops_times(flush: torch.Tensor) -> list[dict]:
    """The wrapper of the package on the path at SHAPES: ms (the median of
    ROUNDS rounds of REPS calls) and the worst relative L2 error against
    autograd of ``wkv_ref``."""
    rows = []
    for BH, T, K, V, chunk in SHAPES:
        args, dout = inputs(BH, T, K, V)
        plain = [t.clone().requires_grad_() for t in args]
        want = torch.autograd.grad(ref.wkv_ref(*plain)[0], plain, dout)
        _, _, ws = wkv.forward_with_states(*args, chunk=chunk)

        def call():
            return wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)

        rel = check(call, want)
        ms = statistics.median(event_ms(call, flush) for _ in range(ROUNDS))
        rows.append(dict(shape=[BH, T, K, V, chunk], ms=ms, rel_l2=rel))
        print(f"ops wkv_chunked_bwd[{BH}x{T}x{K}->{V} chunk={chunk} bf16]: {ms:.4f} ms, "
              f"rel L2 {rel:.2e}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--source", action="append", default=[],
                    help="one more kernel source to build and time beside this one "
                         "(the parent's, say); may be given more than once")
    ap.add_argument("--ops", action="store_true",
                    help="time only the wrapper of the package on the path at SHAPES")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv_bwd: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"device {smi}")
    _build.library()   # the forward kernel
    if a.ops:
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
        print(f"ops: the package at {Path(_build.__file__).parents[2]}", flush=True)
        rows = ops_times(flush)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            Path(a.out).write_text(json.dumps(dict(
                device=smi, package=str(Path(_build.__file__).parents[2]), ops=rows),
                indent=1))
        return
    sources = {"kernel": (_build.CSRC / "wkv_chunked_bwd.cu").read_text(),
               "stamps": instrumented_source()}
    for path in a.source:
        sources[f"source_{Path(path).stem}"] = Path(path).read_text()
    libs = build(sources)
    stamps = libs.pop("stamps")[0]
    ptx = {}
    for name, (_, log) in libs.items():
        ptx[name] = wkv_bwd.ptxas(log)
        for inst, (regs, st, ld) in ptx[name].items():
            print(f"ptxas {name} {inst}: {regs} registers, spill {st} / {ld} bytes")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    results = []
    for shape in SHAPES:
        rec = shape_run(shape, libs, flush)
        BH, T, K, V, chunk = shape
        print(f"wkv_bwd {BH}x{T}x{K}->{V} chunk {chunk} bf16:")
        for name, r in rec["sources"].items():
            ks = ", ".join(f"{k} {v:.4f}" for k, v in r["kernel_ms"].items())
            print(f"  {name} ({r['instance']}): ms {r['ms']:.4f} ({r['ms_min']:.4f}.."
                  f"{r['ms_max']:.4f}) | {ks} | rel L2 {r['rel_l2']:.2e}", flush=True)
        if wkv_bwd.plan(min(chunk, T), K, V, 2)["instance"] == "chunk":
            rec["phases_cycles"] = ph = phases(stamps, shape)
            for J, row in ph["by_tile"].items():
                print(f"  grads tile {J}: cumulative cycles {row}")
            print(f"  grads all {ph['groups']} groups: cumulative cycles {ph['all']}",
                  flush=True)
        results.append(rec)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(dict(device=smi, ptxas=ptx, shapes=results), indent=1))


if __name__ == "__main__":
    main()
