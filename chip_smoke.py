#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device, ``nvcc`` and the checkout this file lies in; no
network.  Imports nothing of JAX or of the JAX package.  Phases, each of
which ends the run with a non-zero exit code if it fails:

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: the four CUDA kernels, from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape one EdgeNeXt-S forward gives it at batch 16 and at ragged /
   odd / bfloat16 cases, ``|a-b| <= tol + tol*|b|`` with tol 3e-5 for
   float32 (2e-4 attention) and 2e-2 for bfloat16: float32 sums taken in
   another order, bfloat16 rounding of the result.  ``matmul_ln`` is on
   no model forward: it runs at the three EdgeNeXt-S shapes the scheduler
   lowers at batch 16 (M = 16384 / 4096 / 1024, K = N = 96 / 160 / 304),
   the two LM widths it lowers (512 x 2048 -> 2048, 448 x 2560 -> 2560),
   two ragged cases and one bfloat16 case, each with the blocks
   ``search.lower`` gives that shape.  Each is timed with CUDA events,
   one pair around each call, the L2 cache flushed before each, median of
   the repeats: the kernel, the plain version, and a library call of the
   same function as a yardstick the port never uses;
4. main path: EdgeNeXt-S at full width and depth (256x256x3, dims
   48/96/160/304, depths 3/3/9/3, 1000 classes, float32, seeded random
   weights) answers 4 requests of 16 images and 2 of 1 through
   ``serve_edgenext.serve``.  The launch counters are set to 0 just before
   and read just after: 18 fused_ibn, 21 depthwise, 3 attention launches a
   forward.  Logits must be finite, [B, 1000], within 2e-3 of the same
   model run with the plain versions on the card, and for one single-image
   request within 2e-3 of the plain model on the CPU;
5. lowered (the scheduler's path): ``auto_schedule`` of every registered
   workload, and every ``lowered`` entry whose kernel is ported launched
   at the layer's true shapes with exactly the emitted ``block_*``
   (fused_ibn: M = b*ox*oy, D = c*fx*fy, F = k, Do = the projection's k;
   matmul_ln: M, K = c*fx*fy, N = k; flash_attention: B*H = b, Sq = ox,
   D = c, Sk = the softmax extent, non-causal), each distinct (kernel,
   shapes, blocks) once, against its plain version with the tolerances
   above.  The launch counters are set to 0 before and read after: every
   ported kernel launches here, matmul_ln only here.  ``rwkv_chunk``
   entries are counted and printed as waiting for ``wkv_chunked``;
6. one JSON line ``{"kernels": [...]}``, the device line, and last
   ``{"ok": true, "device": {...}}``.

Per kernel the JSON line sums over one batch-16 forward: ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are each the sum over the
forward's launches of that kernel (per-shape time x how often the shape
occurs; for matmul_ln, once each of the three EdgeNeXt-S shapes it is
lowered at); ``shapes`` holds the per-shape numbers.  ``launches`` is the
count of the path the kernel is on: the EdgeNeXt-S requests for the
first three, the lowered phase for matmul_ln (``launches_by_path`` has
both).  ``bound_ms`` is the larger of bytes / 3.35 TB/s (each input read
once, each output written once) and operations / peak: 495 TFLOP/s (TF32
tensor cores, the card's rate for a float32 matrix product) for the
products of fused_ibn, attention and matmul_ln, 67 TFLOP/s (float32
outside the tensor cores) for the depthwise convolution, which has no
matrix product; 989 TFLOP/s for bfloat16 products.  The matrix products'
shapes also carry ``bound_fp32_cuda_core_ms``, the same bound at 67
TFLOP/s, the rate of the exact float32 multiply-adds the kernels run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.edgenext_s import CONFIG  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import fused_ibn as ibn_mod  # noqa: E402
from repro_torch.kernels import matmul_ln as mln_mod  # noqa: E402
from repro_torch.models import edgenext  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.search import (WORKLOADS, auto_schedule,  # noqa: E402
                                get_workload, lower)
from repro_torch.core.workload import NORM, PWCONV, Layer  # noqa: E402
from repro_torch.serve_edgenext import serve  # noqa: E402

MEM_BYTES_S = 3.35e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
BATCH = 16
SEED = 0

KERNELS = {
    "fused_ibn": dict(module=ibn_mod,
                      source="src/repro_torch/kernels/csrc/fused_ibn.cu",
                      replaces="src/repro/kernels/fused_ibn.py:102"),
    "depthwise_conv2d": dict(module=dw_mod,
                             source="src/repro_torch/kernels/csrc/depthwise_conv.cu",
                             replaces="src/repro/kernels/depthwise_conv.py:42"),
    "flash_attention": dict(module=fa_mod,
                            source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:86"),
    "matmul_ln": dict(module=mln_mod,
                      source="src/repro_torch/kernels/csrc/matmul_ln.cu",
                      replaces="src/repro/kernels/matmul_ln.py:70"),
}
# the EdgeNeXt-S forward launches the first three; matmul_ln runs only on
# the lowered path
SERVE_KERNELS = ("fused_ibn", "depthwise_conv2d", "flash_attention")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True, timeout=120).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn()``: one event pair around each call,
    the 50 MB L2 cache flushed (a 256 MB buffer zeroed) before each."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}, "
             f"want {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: kernel output not finite")
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        fail(f"{name}: disagrees with the plain version, max abs err "
             f"{err.max().item():.3e} at tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the per-kernel cases
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(SEED)


def randn(*shape, scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    a = (_rng.standard_normal(shape, dtype=np.float32) * scale)
    return torch.from_numpy(a).to(dtype).cuda()


def ibn_case(M, D, Fd, Do, *, gated=False, act="gelu", dtype=torch.float32,
             timed=False, blocks=None, w_scale=(0.1, 0.1)):
    x = randn(M, D, dtype=dtype)
    w1 = randn(D, Fd, scale=w_scale[0], dtype=dtype)
    w2 = randn(Fd, Do, scale=w_scale[1], dtype=dtype)
    wg = randn(D, Fd, scale=w_scale[0], dtype=dtype) if gated else None
    name = f"fused_ibn[{M}x{D}x{Fd}x{Do} {act}{' gated' if gated else ''} " \
           f"{str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    got = ops.fused_ibn(x, w1, w2, wg, activation=act, **(blocks or {}))
    want = ref.fused_ibn_ref(x, w1, w2, wg, activation=act)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol)
    if timed:
        flops = 2.0 * M * (D * Fd * (2 if gated else 1) + Fd * Do)
        moved = nbytes(x, w1, w2, wg, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.fused_ibn(x, w1, w2, wg, activation=act))
        rec["plain_ms"] = time_ms(
            lambda: ref.fused_ibn_ref(x, w1, w2, wg, activation=act))
        rec["library_ms"] = time_ms(
            lambda: torch.matmul(F.gelu(torch.matmul(x, w1), approximate="tanh"), w2))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def ibn_rounding_case():
    """relu2(1 + 2^-7) rounds to 1 + 2^-6 in bfloat16, so against
    w2 = [1 + 2^-6, -1] the two terms cancel exactly: the kernel rounds T to
    the input type before the second product, or it returns -6.1e-5."""
    bf16 = torch.bfloat16
    x = torch.tensor([[1.0]], dtype=bf16, device="cuda")
    w1 = torch.tensor([[1.0, 1.0078125]], dtype=bf16, device="cuda")
    w2 = torch.tensor([[1.015625], [-1.0]], dtype=bf16, device="cuda")
    got = ops.fused_ibn(x, w1, w2, activation="relu2")
    name = "fused_ibn[rounding of T, relu2 bfloat16]"
    err = compare(name, got, ref.fused_ibn_ref(x, w1, w2, activation="relu2"), 0.0)
    if got.float().item() != 0.0:
        fail(f"{name}: {got.float().item()} instead of 0")
    return dict(case=name, max_abs_err=err, tol=2e-2)


def dw_case(B, H, W, C, k, *, dtype=torch.float32, slice_of=None, timed=False):
    if slice_of is None:
        x = randn(B, H, W, C, dtype=dtype)
    else:   # a channel slice of a wider activation, as the SDTA cascade gives
        total, start = slice_of
        x = randn(B, H, W, total, dtype=dtype)[..., start:start + C]
    w = randn(k, k, C, scale=0.2, dtype=dtype)
    b = randn(C, scale=0.1, dtype=dtype)
    name = f"depthwise_conv2d[{B}x{H}x{W}x{C} k{k}" \
           f"{' slice' if slice_of else ''} {str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    got = ops.depthwise_conv2d(x, w, b)
    want = ref.depthwise_conv2d_ref(x, w, b)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol)
    if timed:
        flops = 2.0 * B * H * W * C * k * k
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, w, b, got), flops,
                                                 PEAK_FP32)
        rec["ms"] = time_ms(lambda: ops.depthwise_conv2d(x, w, b))
        rec["plain_ms"] = time_ms(lambda: ref.depthwise_conv2d_ref(x, w, b),
                                  reps=5, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)            # channels_last memory, no copy
        w_oihw = w.permute(2, 0, 1)[:, None].contiguous()
        rec["library_ms"] = time_ms(
            lambda: F.conv2d(x_nchw, w_oihw, b, padding=k // 2, groups=C))
        rec["gbytes_s"] = nbytes(x, w, b, got) / rec["ms"] / 1e6
    return rec


def fa_case(B, H, Sq, Sk, D, *, causal=True, window=None, scale=None,
            dtype=torch.float32, xca=False, timed=False, blocks=None):
    q = randn(B, H, Sq, D, dtype=dtype)
    k = randn(B, H, Sk, D, dtype=dtype)
    v = randn(B, H, Sk, D, dtype=dtype)
    if xca:     # as the model calls it: rows L2-normalised over D, scale 1
        q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
        k = (k / k.norm(dim=-1, keepdim=True)).contiguous()
    name = f"flash_attention[{B}x{H}x{Sq}x{Sk}x{D} causal={causal} " \
           f"window={window} {str(dtype).split('.')[-1]}]"
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    kw = dict(causal=causal, window=window, scale=scale)
    got = ops.flash_attention(q, k, v, **kw, **(blocks or {}))
    want = ref.attention_ref(q, k, v, **kw)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol)
    if timed:
        if causal or window is not None:
            raise ValueError("timed cases are the XCA shapes: no mask")
        flops = 4.0 * B * H * Sq * Sk * D
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(q, k, v, got), flops, peak)
        rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, **kw))
        rec["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        rec["gbytes_s"] = nbytes(q, k, v, got) / rec["ms"] / 1e6
    return rec


def mln_blocks(M, K, N):
    """The blocks ``search.lower`` gives a matmul_ln of these extents
    (with the search's default tiles, 64 rows and 128 columns)."""
    lk = lower.lower_matmul_ln(Layer("mac", PWCONV, k=N, c=K, ox=M),
                               Layer("ln", NORM, c=N, ox=M),
                               tile_x=64, tile_c=128)
    return lk.params


def mln_case(M, K, N, *, dtype=torch.float32, blocks=None, timed=False):
    x = randn(M, K, dtype=dtype)
    w = randn(K, N, scale=K ** -0.5, dtype=dtype)
    b = randn(N, scale=0.1, dtype=dtype)
    g = (1.0 + randn(N, scale=0.1)).to(dtype)
    be = randn(N, scale=0.1, dtype=dtype)
    blocks = blocks or mln_blocks(M, K, N)
    name = f"matmul_ln[{M}x{K}->{N} block_m={blocks['block_m']} " \
           f"block_k={blocks['block_k']} {str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    got = ops.matmul_ln(x, w, b, g, be, **blocks)
    want = ref.matmul_ln_ref(x, w, b, g, be)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol)
    if timed:
        flops = 2.0 * M * N * K
        moved = nbytes(x, w, b, g, be, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.matmul_ln(x, w, b, g, be, **blocks))
        rec["plain_ms"] = time_ms(lambda: ref.matmul_ln_ref(x, w, b, g, be))
        rec["library_ms"] = time_ms(
            lambda: F.layer_norm(x @ w + b, (N,), g, be, 1e-6))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def path_shapes(cfg, batch):
    """(kernel, arguments, launches per forward) for every shape one
    forward of ``cfg`` at ``batch`` gives each kernel."""
    ibn, dw, fa = [], [], []
    hw = cfg.img_size // 4
    for si in range(4):
        c, k = cfg.dims[si], cfg.kernel_sizes[si]
        if si:
            hw //= 2
        n_sdta = cfg.sdta_blocks[si]
        n_conv = cfg.depths[si] - n_sdta
        ibn.append(((batch * hw * hw, c + 1, cfg.expan_ratio * c, c),
                    cfg.depths[si]))
        if n_conv:
            dw.append(((batch, hw, hw, c, k, None), n_conv))
        if n_sdta:
            widths = edgenext._split_widths(c, cfg.sdta_scales[si])
            start = widths[0]
            for i, wd in enumerate(widths[1:]):
                # the first split is a channel slice of the activation, the
                # later ones are dense sums
                dw.append(((batch, hw, hw, wd, 3, (c, start) if i == 0 else None),
                           n_sdta))
                start += wd
            fa.append(((batch, cfg.heads, c // cfg.heads, hw * hw), n_sdta))
    return ibn, dw, fa


def merge_counts(items):
    """[(args, n), ...] -> the same with equal args merged."""
    out: dict = {}
    for args, n in items:
        out[args] = out.get(args, 0) + n
    return list(out.items())


def kernels_phase():
    ibn, dw, fa = path_shapes(CONFIG, BATCH)
    per_kernel = {name: dict(shapes=[], extra=[]) for name in KERNELS}

    for (M, D, Fd, Do), n in merge_counts(ibn):
        rec = ibn_case(M, D, Fd, Do, timed=True)
        rec["per_forward"] = n
        per_kernel["fused_ibn"]["shapes"].append(rec)
    for (B, H, W, C, k, sl), n in merge_counts(dw):
        rec = dw_case(B, H, W, C, k, slice_of=sl, timed=True)
        rec["per_forward"] = n
        per_kernel["depthwise_conv2d"]["shapes"].append(rec)
    for (B, H, S, D), n in merge_counts(fa):
        rec = fa_case(B, H, S, S, D, causal=False, scale=1.0, xca=True, timed=True)
        rec["per_forward"] = n
        per_kernel["flash_attention"]["shapes"].append(rec)

    # matmul_ln: the EdgeNeXt-S lowered shapes at batch 16 (once each), then
    # the LM widths, ragged and bfloat16 cases (timed, outside the sums)
    mln = [((BATCH * hw * hw, c, c), 1) for hw, c in
           zip((32, 16, 8), CONFIG.dims[1:])]
    mln += [((512, 2048, 2048), 0), ((448, 2560, 2560), 0),
            ((197, 48, 160), 0), ((7, 13, 24), 0)]
    for (M, K, N), n in mln:
        rec = mln_case(M, K, N, timed=True)
        rec["per_forward"] = n
        per_kernel["matmul_ln"]["shapes"].append(rec)
    rec = mln_case(197, 48, 160, dtype=torch.bfloat16, timed=True)
    rec["per_forward"] = 0
    per_kernel["matmul_ln"]["shapes"].append(rec)

    bf16 = torch.bfloat16
    per_kernel["fused_ibn"]["extra"] = [
        ibn_case(197, 48, 160, 48),
        ibn_case(197, 48, 160, 48, gated=True, act="silu"),
        ibn_case(197, 48, 160, 48, act="relu2"),
        ibn_case(100, 64, 300, 400, gated=True, act="gelu"),   # Do over 2 blocks
        ibn_case(197, 48, 160, 48, dtype=bf16),
        ibn_case(197, 48, 160, 48, gated=True, act="silu", dtype=bf16),
        ibn_rounding_case(),
    ]
    per_kernel["depthwise_conv2d"]["extra"] = [
        dw_case(1, 10, 14, 52, 5),
        dw_case(2, 9, 7, 33, 7),
        dw_case(2, 16, 16, 52, 5, dtype=bf16),
    ]
    per_kernel["flash_attention"]["extra"] = [
        fa_case(2, 2, 64, 64, 16, causal=True),
        fa_case(2, 2, 64, 128, 16, causal=True, window=24),
        fa_case(1, 2, 160, 304, 16, causal=True, window=48),
        fa_case(1, 2, 197, 197, 16, causal=False),
        fa_case(1, 2, 128, 64, 8, causal=False),
        fa_case(1, 1, 100, 40, 8, causal=True, window=10),   # rows with no key
        fa_case(1, 2, 33, 77, 1500, causal=True),            # D over 2 blocks
        fa_case(1, 2, 64, 64, 32, causal=True, dtype=bf16),
    ]
    return per_kernel


def lowered_phase():
    """Every ``lowered`` entry of every registered workload whose kernel is
    ported, launched with the emitted blocks at the layer's true shapes
    and held against its plain version; identical (kernel, shapes,
    blocks) once.  Returns the per-launch records, the entries per kernel,
    the rwkv_chunk entries per workload and the launch counts."""
    distinct: dict = {}
    entries: dict = {name: 0 for name in KERNELS}
    waiting: dict = {}
    for wname in WORKLOADS:
        layers = get_workload(wname)
        sched = auto_schedule(layers, workload=wname)
        for key, lk in sched.lowered.items():
            kern = lk["kernel"]
            if kern not in KERNELS:
                waiting[wname] = waiting.get(wname, 0) + 1
                continue
            shape = lower.launch_shape(layers, key, lk)
            blocks = {k: v for k, v in lk.items() if k.startswith("block_")}
            dkey = (kern, tuple(shape.items()), tuple(sorted(blocks.items())))
            distinct.setdefault(dkey, []).append(f"{wname}:{key}")
            entries[kern] += 1

    torch.cuda.synchronize()
    for info in KERNELS.values():
        info["module"].launches = 0
    records = []
    for (kern, shape, blocks), where in distinct.items():
        s, blocks = dict(shape), dict(blocks)
        if kern == "fused_ibn":
            rec = ibn_case(s["m"], s["d"], s["f"], s["do"], blocks=blocks,
                           w_scale=(s["d"] ** -0.5, s["f"] ** -0.5))
        elif kern == "matmul_ln":
            rec = mln_case(s["m"], s["k"], s["n"], blocks=blocks)
        else:
            rec = fa_case(1, s["bh"], s["q"], s["k"], s["d"], causal=False,
                          blocks=blocks)
        rec.update(kernel=kern, blocks=blocks, entries=len(where),
                   first=where[0])
        records.append(rec)
    torch.cuda.synchronize()
    launches = {name: info["module"].launches for name, info in KERNELS.items()}
    for name in KERNELS:
        want = sum(1 for r in records if r["kernel"] == name)
        if launches[name] != want:
            fail(f"lowered: {name} launched {launches[name]} times for "
                 f"{want} distinct lowered launches")
    if not launches["matmul_ln"]:
        fail("lowered: matmul_ln was never launched")
    return records, entries, waiting, launches


def summarise(per_kernel, launches):
    rows = []
    for name, info in KERNELS.items():
        shapes = per_kernel[name]["shapes"]
        total = lambda key: sum(s[key] * s["per_forward"] for s in shapes)  # noqa: E731
        by = {"bytes": 0.0, "operations": 0.0}
        for s in shapes:
            by[s["bound_by"]] += s["bound_ms"] * s["per_forward"]
        f32_errs = [s["max_abs_err"] for s in shapes + per_kernel[name]["extra"]
                    if s["tol"] < 1e-2]
        path = "edgenext_serve" if name in SERVE_KERNELS else "lowered"
        rows.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[path][name],
            launches_by_path={p: n[name] for p, n in launches.items()},
            max_abs_err=max(f32_errs), ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=max(by, key=by.get), library_ms=total("library_ms"),
            launches_per_forward=sum(s["per_forward"] for s in shapes),
            batch=BATCH, shapes=shapes, extra=per_kernel[name]["extra"]))
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path():
    cfg = CONFIG
    params = init_params(SEED, edgenext.param_defs(cfg), perturb=0.05)
    model = edgenext.EdgeNeXt(cfg, params).eval()
    plain = edgenext.EdgeNeXt(cfg, params, kernels=ref.PLAIN).eval()
    rng = np.random.default_rng(SEED + 1)
    sizes = [BATCH] * 4 + [1] * 2
    batches = [torch.from_numpy(rng.standard_normal(
        (b, cfg.img_size, cfg.img_size, cfg.in_channels), dtype=np.float32)).cuda()
        for b in sizes]

    serve(model, [batches[0], batches[-1]])       # warm-up, one of each size
    torch.cuda.synchronize()
    for info in KERNELS.values():
        info["module"].launches = 0
    logits, ms = serve(model, batches)
    torch.cuda.synchronize()
    launches = {name: info["module"].launches for name, info in KERNELS.items()}

    want = edgenext.kernel_launches_per_forward(cfg)
    if want != {"fused_ibn": 18, "depthwise_conv2d": 21, "flash_attention": 3}:
        fail(f"EdgeNeXt-S should launch 18/21/3 a forward, model says {want}")
    for name, n in launches.items():
        if n != want.get(name, 0) * len(batches):
            fail(f"{name}: {n} launches over {len(batches)} requests, "
                 f"expected {want[name]} a forward")

    serve(plain, [batches[0], batches[-1]])
    plain_logits, plain_ms = serve(plain, batches)
    worst = 0.0
    for i, (got, ref_out) in enumerate(zip(logits, plain_logits)):
        if got.shape != (sizes[i], cfg.num_classes) or got.dtype != torch.float32:
            fail(f"request {i}: logits {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            fail(f"request {i}: logits not finite")
        worst = max(worst, (got - ref_out).abs().max().item())
    if worst > 2e-3:
        fail(f"logits differ from the plain versions on the card by {worst:.3e} "
             f"(limit 2e-3)")

    # one single-image request against the plain model on the CPU
    cpu_model = edgenext.EdgeNeXt(cfg, params, device="cpu").eval()
    with torch.inference_mode():
        cpu_logits = cpu_model(batches[-1].cpu())
    cpu_err = (logits[-1].cpu() - cpu_logits).abs().max().item()
    if cpu_err > 2e-3:
        fail(f"logits differ from the plain model on the CPU by {cpu_err:.3e} "
             f"(limit 2e-3)")

    # steadier request times: ten more of each size
    _, ms16 = serve(model, [batches[0]] * 10)
    _, ms1 = serve(model, [batches[-1]] * 10)
    _, pms16 = serve(plain, [batches[0]] * 5)
    _, pms1 = serve(plain, [batches[-1]] * 5)
    result = dict(
        requests=sizes, request_ms=ms, plain_request_ms=plain_ms,
        launches=launches, max_abs_err_vs_plain_on_card=worst,
        max_abs_err_vs_plain_on_cpu=cpu_err,
        logits_abs_max=max(x.abs().max().item() for x in logits),
        ms_per_request_b16=statistics.median(ms16),
        ms_per_request_b1=statistics.median(ms1),
        plain_ms_per_request_b16=statistics.median(pms16),
        plain_ms_per_request_b1=statistics.median(pms1),
        peak_memory_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    return launches, result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA device only", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = run_text([_build._nvcc(), "--version"]).splitlines()[-2:]
    print(f"device {smi}")
    print(f"versions python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {' | '.join(nvcc)}", flush=True)

    # 2. build
    _build.library()
    built = _build.build_seconds
    print(f"build {len(_build.sources())} sources -> {_build.build_dir()} in "
          f"{'(reused)' if built is None else f'{built:.1f} s'} (set-up)")
    for line in _build.ptxas_log().splitlines():
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            print(f"ptxas {line.strip()}")
    regs = [int(tok) for line in _build.ptxas_log().splitlines() if "Used" in line
            for tok in [line.split("Used")[1].split()[0]]]
    print(f"ptxas {len(regs)} kernels, registers {min(regs)}..{max(regs)} a thread",
          flush=True)

    # 3. kernels against their plain versions
    per_kernel = kernels_phase()
    for name, rec in per_kernel.items():
        for s in rec["shapes"]:
            print(f"kernel {s['case']} x{s['per_forward']}: err {s['max_abs_err']:.2e} "
                  f"ms {s['ms']:.4f} plain {s['plain_ms']:.4f} library "
                  f"{s['library_ms']:.4f} bound {s['bound_ms']:.4f} ({s['bound_by']})")
        for s in rec["extra"]:
            print(f"kernel {s['case']}: err {s['max_abs_err']:.2e} (tol {s['tol']})")
    sys.stdout.flush()

    # 4. main path
    launches, served = main_path()
    print(f"main_path EdgeNeXt-S requests {served['requests']} launches {launches} "
          f"err_vs_plain {served['max_abs_err_vs_plain_on_card']:.2e} "
          f"err_vs_cpu {served['max_abs_err_vs_plain_on_cpu']:.2e} "
          f"|logits| <= {served['logits_abs_max']:.3f}")
    print(f"main_path ms/request B=16 {served['ms_per_request_b16']:.3f} "
          f"(plain {served['plain_ms_per_request_b16']:.3f}) "
          f"B=1 {served['ms_per_request_b1']:.3f} "
          f"(plain {served['plain_ms_per_request_b1']:.3f}) "
          f"peak memory {served['peak_memory_mib']:.0f} MiB")

    # 5. the scheduler's path: every lowered entry onto its kernel
    lowered, entries, waiting, lowered_launches = lowered_phase()
    for name in KERNELS:
        recs = [r for r in lowered if r["kernel"] == name]
        if not recs:
            continue
        print(f"lowered {name}: {entries[name]} entries over {len(WORKLOADS)} "
              f"workloads, {len(recs)} distinct launches, all passed, max err "
              f"{max(r['max_abs_err'] for r in recs):.2e} (tol {recs[0]['tol']})")
    print(f"lowered rwkv_chunk: {sum(waiting.values())} entries waiting for "
          f"wkv_chunked (not ported): {waiting}", flush=True)

    # 6. results
    rows = summarise(per_kernel, {"edgenext_serve": launches,
                                  "lowered": lowered_launches})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            device=device, nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, nvcc=nvcc, build_seconds=built,
            kernels=rows, main_path=served,
            lowered=dict(records=lowered, entries=entries,
                         waiting_rwkv_chunk=waiting)), indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
