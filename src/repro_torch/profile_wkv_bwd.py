"""Where a call of the WKV backward kernel spends its time.

    python -m repro_torch.profile_wkv_bwd [--out FILE.json]

Needs one CUDA device and ``nvcc``.  At RWKV-6's trained shape (B*H =
4*32, T = 512, K = V = 64, chunk 64, bfloat16 r/k/v/dout, float32 logw
and u) and at the B = 1 x 200 prompt (32 x 200, chunk 64), it gives:

- each of the call's three kernels (the reverse states pass, the
  gradients pass, the finishing pass) by ``torch.profiler``, the mean
  device time over CALLS calls, beside the forward kernel's two passes on
  the same inputs;
- the phases of the gradients pass, from a copy of
  ``csrc/wkv_chunked_bwd.cu`` built under ``build/profile_wkv_bwd/`` with
  ``clock64`` stamps (the library the port loads is not touched): for
  every block, the SM cycles from its start to the end of each of PHASES
  (loads landed, cumsum, diagonal block, chunk states, visits of the other
  tiles, stores), cumulative; the median over the blocks of each tile
  index of a chunk (tile 0 visits the three later tiles, tile 3 the three
  earlier ones) and over all blocks.

Every kernel is checked against the plain ``ref.wkv_ref`` under autograd
once first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv_chunk as wkv
from repro_torch.kernels import rwkv_chunk_bwd as wkv_bwd

SHAPES = ((128, 512, 64, 64, 64), (32, 200, 64, 64, 64))
CALLS = 10
PHASES = ("loads", "cumsum", "diagonal", "states", "visits", "stores")
MAX_BLOCKS = 8192
BUILD = Path(__file__).resolve().parents[2] / "build" / "profile_wkv_bwd"

# (anchor text in the kernel, stamp inserted after it): the end of each
# of PHASES in ``wkv_grads_kernel``
_STAMPS = (
    ("  cp_async_wait<0>();\n  __syncthreads();\n", 0),
    ("      for (int s = lo; s < hi; ++s) bz[(s + 1) * ldk + kk] += before;\n    }\n  }\n"
     "  __syncthreads();\n", 1),
    ("    q1[s * ldk + kk] = ko[s * ldk + kk] * ex2(bC[kk] - bb(j0 + s, kk));\n  }\n"
     "  __syncthreads();\n", 2),
    ("                [&](int s, int vv, float x) { adv[s * ldv + vv] += x; });\n"
     "  __syncthreads();\n\n", 3),
    ("    __syncthreads();\n  }\n\n  // 5.", 4),
)


def instrumented_source() -> str:
    """csrc/wkv_chunked_bwd.cu with the stamps in; raises if the kernel no
    longer has the text a stamp goes after."""
    src = (_build.CSRC / "wkv_chunked_bwd.cu").read_text()

    def once(anchor: str, new: str) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_wkv_bwd: the kernel changed near {anchor!r}")
        src = src.replace(anchor, new)

    once("constexpr unsigned FULL = 0xffffffffu;\n",
         "constexpr unsigned FULL = 0xffffffffu;\n"
         f"__device__ long long g_stamps[{MAX_BLOCKS} * 8];\n")
    once("  const long long row0 = bh * T + c0;   // the chunk's first row\n",
         "  const long long row0 = bh * T + c0;   // the chunk's first row\n"
         "  const long long t_start = clock64();\n  long long ph[8] = {};\n")
    for anchor, slot in _STAMPS:
        stamp = f"  ph[{slot}] = clock64() - t_start;\n"
        if anchor.endswith("// 5."):
            once(anchor, anchor[:-len("  // 5.")] + stamp + "  // 5.")
        else:
            once(anchor, anchor + stamp)
    once("    from_f32(adv[t * ldv + vv] + rkb[t] * dob[t * ldv + vv], "
         "dv + (row0 + j0 + t) * V + vv);\n  }\n}\n",
         "    from_f32(adv[t * ldv + vv] + rkb[t] * dob[t * ldv + vv], "
         "dv + (row0 + j0 + t) * V + vv);\n  }\n  __syncthreads();\n"
         "  ph[5] = clock64() - t_start;\n"
         "  const long long blk = blockIdx.x * (long long)gridDim.y + blockIdx.y;\n"
         f"  if (tid == 0 && blk < {MAX_BLOCKS})\n"
         "    for (int i = 0; i < 8; ++i) g_stamps[blk * 8 + i] = ph[i];\n}\n")
    return src + ('\nextern "C" int repro_wkv_bwd_stamps(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n")


def stamps_library() -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / "wkv_chunked_bwd.cu"
    src.write_text(instrumented_source())
    lib = BUILD / "libwkv_bwd_stamps.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib), str(src)], check=True, stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT)
    return ctypes.CDLL(str(lib))


def inputs(BH, T, K, V, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    r, k = (0.5 * torch.randn(BH, T, K, device="cuda", generator=g) for _ in range(2))
    v = 0.5 * torch.randn(BH, T, V, device="cuda", generator=g)
    logw = -torch.exp(0.5 * torch.randn(BH, T, K, device="cuda", generator=g))
    u = 0.5 * torch.randn(BH, K, device="cuda", generator=g)
    dout = torch.randn(BH, T, V, device="cuda", generator=g)
    return (r.to(bf), k.to(bf), v.to(bf), logw, u), dout.to(bf)


def check(args, dout, chunk) -> float:
    """The backward through ``ops``' route against autograd of ``wkv_ref``:
    the worst relative L2 error over the five gradients."""
    leaves = [t.clone().requires_grad_() for t in args]
    got = torch.autograd.grad(wkv.WKVChunked.apply(*leaves, chunk)[0], leaves, dout)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.wkv_ref(*plain)[0], plain, dout)
    worst = max(((g.float() - w.float()).norm() / w.float().norm()).item()
                for g, w in zip(got, want))
    if not worst < 1e-2:
        raise RuntimeError(f"profile_wkv_bwd: the backward disagrees (rel L2 {worst:.3e})")
    return worst


def kernel_times(args, dout, chunk) -> dict:
    """Mean device ms a call of each kernel of the forward and the
    backward, over CALLS calls, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    _, _, ws = wkv.forward_with_states(*args, chunk=chunk)
    for _ in range(3):
        wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            wkv.forward_with_states(*args, chunk=chunk)
            wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        for name in ("wkv_states_kernel", "wkv_outputs_kernel", "wkv_rstates_kernel",
                     "wkv_grads_kernel", "wkv_finish_kernel"):
            if us and name in ev.key:
                out[name] = us / 1e3 / CALLS
    return out


def phases(lib, args, dout, chunk) -> dict:
    """Cumulative SM cycles at the end of each of PHASES in the gradients
    pass of the instrumented copy: medians by tile index and overall."""
    fn = lib.repro_wkv_chunked_bwd
    fn.argtypes, fn.restype = wkv_bwd._ARGTYPES, ctypes.c_int
    real = wkv_bwd._kernel
    wkv_bwd._kernel = lambda: fn
    try:
        _, _, ws = wkv.forward_with_states(*args, chunk=chunk)
        wkv_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk)
        torch.cuda.synchronize()
    finally:
        wkv_bwd._kernel = real
    host = np.zeros(MAX_BLOCKS * 8, np.int64)
    if lib.repro_wkv_bwd_stamps(host.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("profile_wkv_bwd: reading the stamps failed")
    BH, T, _ = args[0].shape
    tpc = -(-min(chunk, T) // wkv_bwd.TILE)
    n_tiles = -(-T // min(chunk, T)) * tpc
    st = host.reshape(MAX_BLOCKS, 8)[:min(MAX_BLOCKS, BH * n_tiles), :len(PHASES)]
    blocks = np.arange(len(st))
    live = st[:, -1] > 0     # blocks past T write no stamps
    by_tile = {}
    for J in range(tpc):
        sel = live & ((blocks % n_tiles) % tpc == J)
        by_tile[J] = dict(zip(PHASES, np.median(st[sel], 0).astype(int).tolist()))
    return dict(by_tile=by_tile,
                all=dict(zip(PHASES, np.median(st[live], 0).astype(int).tolist())),
                blocks=int(live.sum()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv_bwd: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(f"device {smi}")
    _build.library()
    lib = stamps_library()
    results = []
    for BH, T, K, V, chunk in SHAPES:
        args, dout = inputs(BH, T, K, V)
        rec = dict(shape=[BH, T, K, V, chunk], rel_l2=check(args, dout, chunk),
                   kernel_ms=kernel_times(args, dout, chunk),
                   phases_cycles=phases(lib, args, dout, chunk))
        results.append(rec)
        ms = ", ".join(f"{k} {v:.4f}" for k, v in rec["kernel_ms"].items())
        print(f"wkv_bwd {BH}x{T}x{K}->{V} chunk {chunk} (rel L2 {rec['rel_l2']:.2e}): "
              f"ms a call {ms}")
        ph = rec["phases_cycles"]
        for J, row in ph["by_tile"].items():
            print(f"  grads tile {J}: cumulative cycles {row}")
        print(f"  grads all {ph['blocks']} blocks: cumulative cycles {ph['all']}", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(dict(device=smi, shapes=results), indent=1))


if __name__ == "__main__":
    main()
