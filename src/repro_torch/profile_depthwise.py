"""Every tile of the depthwise convolution at the EdgeNeXt-S shapes.

    python -m repro_torch.profile_depthwise [--out FILE.json]

Needs one CUDA device and ``nvcc``.  For each shape one EdgeNeXt-S
forward gives ``csrc/depthwise_conv.cu`` at batch 16 and at batch 1 (the
first SDTA split of a stage is a channel slice of the activation, as the
model hands it over; float32), it times the kernel at every tile
``kernels.depthwise_conv.candidates`` lists, checks each against
``F.conv2d(groups=C)`` (TF32 off) and times that library call on the same
inputs, and marks the tile ``kernels.depthwise_conv.plan`` picks.  Times
are CUDA-event medians of 10 calls, one event pair around each call of
the C entry point (no wrapper on the host), the 50 MB L2 cache flushed (a
256 MB buffer zeroed) before each.  Each shape prints the plan's tile and
its rank, the fastest tiles, and each tile's blocks, threads, waves and
the plan's time model.  The first line times the smallest launch (one
block, 1 x 4 x 4 x 4, k3): the fixed cost of a launch measured this way.

Then the phases of one launch at the tile ``plan`` picks: a copy of the
kernel with ``%globaltimer`` stamps (built under
``build/profile_depthwise/``; the library the port loads is not touched)
gives, for block (0, 0, 0), microseconds from its start to each of
PHASES, and over all blocks the span from the first start to the last
end, the last start and the longest block; medians of 7 calls, the L2
flushed before each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.edgenext_s import CONFIG
from repro_torch.kernels import _build
from repro_torch.kernels import depthwise_conv as dw
from repro_torch.models import edgenext
from repro_torch.profile_flash_attention import time_ms

SEED = 0
PHASES = ["halo landed", "taps done", "stored"]


def _stamp(slot: int) -> str:
    return ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && "
            f"blockIdx.z == 0) prof_t[{slot}] = prof_now();")


# (text in csrc/depthwise_conv.cu, the probe, the probe goes before it);
# each text must occur once
_PROBES = [
    ('#include "cp_async.cuh"\n', """
__device__ unsigned long long prof_t[16];  // block (0, 0, 0); [8] first start, [9] last start,
                                           // [10] last end, [11] longest block
__device__ __forceinline__ unsigned long long prof_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""", False),
    ("  const int py0 = (fy - 1) / 2, px0 = (fx - 1) / 2;\n", """
  const unsigned long long prof_t0 = prof_now();
  if (threadIdx.x == 0) {
    atomicMin(&prof_t[8], prof_t0);
    atomicMax(&prof_t[9], prof_t0);
  }
  """ + _stamp(0) + "\n", False),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", "  " + _stamp(1) + "\n", False),
    ("  // 3. the bias, one rounding to T, the store\n", "  " + _stamp(2) + "\n", True),
    ("    *reinterpret_cast<Pack<T, CV>*>(orow + (long long)(ox + o) * C) = pk;\n  }\n",
     "  " + _stamp(3) + """
  if (threadIdx.x == 0) {
    const unsigned long long t1 = prof_now();
    atomicMax(&prof_t[10], t1);
    atomicMax(&prof_t[11], t1 - prof_t0);
  }
""", False),
]
_END = """
extern "C" int profile_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, prof_t, sizeof(prof_t));
}
extern "C" int profile_reset() {
  unsigned long long h[16] = {};
  h[8] = ~0ull;
  return (int)cudaMemcpyToSymbol(prof_t, h, sizeof(h));
}
"""


def instrumented_source() -> str:
    """csrc/depthwise_conv.cu with the stamps in; raises if the kernel no
    longer has the text a probe goes after."""
    src = (_build.CSRC / "depthwise_conv.cu").read_text()
    for anchor, probe, before in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_depthwise: {anchor!r} occurs "
                               f"{src.count(anchor)} times in depthwise_conv.cu")
        src = src.replace(anchor, probe + anchor if before else anchor + probe)
    return src + _END


def _library(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.headers():
        shutil.copy(header, out_dir / header.name)
    src = out_dir / "depthwise_conv_profiled.cu"
    src.write_text(instrumented_source())
    lib = out_dir / "libdepthwise_conv_profiled.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(lib), str(src)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed\n" + run.stdout)
    return ctypes.CDLL(str(lib))


def shapes(batch: int) -> list[tuple]:
    """(B, H, W, C, k, (wider C, first channel) or None, launches a
    forward) of every distinct depthwise launch of an EdgeNeXt-S forward."""
    out: dict = {}
    hw = CONFIG.img_size // 4
    for si in range(4):
        c, k = CONFIG.dims[si], CONFIG.kernel_sizes[si]
        if si:
            hw //= 2
        n_sdta = CONFIG.sdta_blocks[si]
        n_conv = CONFIG.depths[si] - n_sdta
        if n_conv:
            key = (batch, hw, hw, c, k, None)
            out[key] = out.get(key, 0) + n_conv
        if n_sdta:
            widths = edgenext._split_widths(c, CONFIG.sdta_scales[si])
            start = widths[0]
            for i, wd in enumerate(widths[1:]):
                # the first split is a channel slice, the later ones dense sums
                key = (batch, hw, hw, wd, 3, (c, start) if i == 0 else None)
                out[key] = out.get(key, 0) + n_sdta
                start += wd
    return [(*key, n) for key, n in out.items()]


def _inputs(B, H, W, C, k, slice_of):
    rng = np.random.default_rng(SEED)
    total, start = slice_of or (C, 0)
    x = torch.from_numpy(rng.standard_normal((B, H, W, total), dtype=np.float32)
                         ).cuda()[..., start:start + C]
    w = torch.from_numpy(rng.standard_normal((k, k, C), dtype=np.float32) * 0.2).cuda()
    b = torch.from_numpy(rng.standard_normal((C,), dtype=np.float32) * 0.1).cuda()
    return x, w, b


def _launcher(fn, x, w, b, out, k, tile):
    B, H, W, C = x.shape
    ps = dw._pixel_stride(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        return fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H,
                  W, C, ps, k, k, tile["th"], tile["tw"], tile["cb"], tile["cv"],
                  0, stream)
    return launch


def sweep(B, H, W, C, k, slice_of, flush: torch.Tensor, sms: int) -> dict:
    x, w, b = _inputs(B, H, W, C, k, slice_of)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(2, 0, 1)[:, None].contiguous()
    want = F.conv2d(x_nchw, w_oihw, b, padding=k // 2, groups=C).permute(0, 2, 3, 1)
    align = dw.alignment(x, w, dw._pixel_stride(x))
    chosen = dw.plan(B, H, W, C, k, k, sms, align=align)
    fn = dw._kernel()
    runs = []
    for tile in dw.candidates(B, H, W, C, k, k, sms, align=align):
        launch = _launcher(fn, x, w, b, out, k, tile)
        out.zero_()
        if launch() != 0:
            raise RuntimeError(f"launch failed at {tile}")
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if err > 3e-5 * (1 + want.abs().max().item()):
            raise RuntimeError(f"profile_depthwise: {B}x{H}x{W}x{C} k{k} at {tile}: "
                               f"max err {err:.3e}")
        runs.append(dict(tile, ms=time_ms(launch, flush), max_abs_err=err,
                         planned=all(tile[key] == chosen[key]
                                     for key in ("th", "tw", "cb"))))
    library = time_ms(lambda: F.conv2d(x_nchw, w_oihw, b, padding=k // 2, groups=C),
                      flush)
    return dict(b=B, h=H, w=W, c=C, k=k, slice_of=slice_of, library_ms=library,
                runs=runs)


def phases(lib: ctypes.CDLL, B, H, W, C, k, slice_of, flush: torch.Tensor,
           sms: int, calls: int = 7) -> dict:
    """Block (0, 0, 0)'s phases and the span over all blocks of one launch
    at the tile ``plan`` picks (microseconds, medians of ``calls``)."""
    x, w, b = _inputs(B, H, W, C, k, slice_of)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    p = dw.plan(B, H, W, C, k, k, sms, align=dw.alignment(x, w, dw._pixel_stride(x)))
    fn = lib.repro_depthwise_conv2d
    fn.argtypes, fn.restype = dw._ARGTYPES, ctypes.c_int
    lib.profile_read.argtypes = [ctypes.c_void_p]
    launch = _launcher(fn, x, w, b, out, k, p)
    rows = []
    for _ in range(calls + 1):      # the first call is a warm-up
        flush.zero_()
        if lib.profile_reset() != 0:
            raise RuntimeError("profile_depthwise: reset failed")
        err = launch()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"profile_depthwise: launch failed, CUDA error {err}")
        t = np.zeros(16, dtype=np.uint64)
        if lib.profile_read(t.ctypes.data) != 0:
            raise RuntimeError("profile_depthwise: read failed")
        t = [int(v) for v in t]
        rows.append([(t[i] - t[0]) / 1e3 for i in range(1, 4)]
                    + [(t[10] - t[8]) / 1e3, (t[9] - t[8]) / 1e3, t[11] / 1e3])
    med = [statistics.median(r[i] for r in rows[1:]) for i in range(len(rows[0]))]
    return dict(b=B, h=H, w=W, c=C, k=k, th=p["th"], tw=p["tw"], cb=p["cb"],
                cv=p["cv"], ctas=p["ctas"], block00_us=dict(zip(PHASES, med[:3])),
                span_us=med[3], last_start_us=med[4], longest_block_us=med[5])


def _name(B, H, W, C, k, slice_of) -> str:
    return f"{B}x{H}x{W}x{C} k{k}{' slice' if slice_of else ''}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--top", type=int, default=5, help="fastest tiles printed a shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_depthwise: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device {smi}", flush=True)
    _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    floor = sweep(1, 4, 4, 4, 3, None, flush, sms)["runs"]
    floor = min(r["ms"] for r in floor if r["ctas"] == 1)
    print(f"floor: one block (1 x 4 x 4 x 4, k3) {floor:.4f} ms", flush=True)
    results = []
    for batch in (16, 1):
        for B, H, W, C, k, sl, n in shapes(batch):
            r = sweep(B, H, W, C, k, sl, flush, sms)
            r["per_forward"] = n
            results.append(r)
            runs = sorted(r["runs"], key=lambda x: x["ms"])
            rank = next(i for i, x in enumerate(runs) if x["planned"])
            best = runs[0]["ms"]
            print(f"depthwise {_name(B, H, W, C, k, sl)} x{n}: library "
                  f"{r['library_ms']:.4f} ms, {len(runs)} tiles, plan's rank "
                  f"{rank + 1} at {runs[rank]['ms']:.4f} ms ({runs[rank]['ms'] / best:.2f}x "
                  f"the fastest)", flush=True)
            for i, run in enumerate(runs):
                if i < args.top or run["planned"]:
                    print(f"  th {run['th']} tw {run['tw']} cb {run['cb']} cv {run['cv']}: "
                          f"{run['ms']:.4f} ms, ctas {run['ctas']}, threads "
                          f"{run['threads']}, waves {run['waves']}, est "
                          f"{run['est_us']:.2f} us{'  <- plan' if run['planned'] else ''}",
                          flush=True)
    lib = _library(_build._build_root() / "profile_depthwise")
    timelines = []
    for batch in (16, 1):
        for B, H, W, C, k, sl, _ in shapes(batch):
            r = phases(lib, B, H, W, C, k, sl, flush, sms)
            timelines.append(r)
            steps = ", ".join(f"{key} {v:.2f}" for key, v in r["block00_us"].items())
            print(f"phases {_name(B, H, W, C, k, sl)} tile {r['th']}x{r['tw']}x{r['cb']} "
                  f"cv {r['cv']} ctas {r['ctas']}: block (0,0,0) us: {steps}; all "
                  f"blocks: span {r['span_us']:.2f}, last start {r['last_start_us']:.2f}, "
                  f"longest block {r['longest_block_us']:.2f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, floor_ms=floor, shapes=results,
                           phases=timelines), f, indent=1)


if __name__ == "__main__":
    main()
