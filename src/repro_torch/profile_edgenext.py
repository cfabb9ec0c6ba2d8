"""Where an EdgeNeXt-S request spends its time on the card.

    PYTHONPATH=src python -m repro_torch.profile_edgenext [--batches 1 16]
        [--requests 20] [--traced 5] [--plain] [--out profile.json]

For each batch size, the model eager and then captured as a CUDA graph
(``runtime.capture.captured(model)``): the request time by the host clock
(ending in a synchronise) and by CUDA events, then a ``torch.profiler``
trace of a few requests, summed by kernel name: the device's busy share of
the traced window (1 - idle share), the hand-written kernels' share of the
busy time, the device kernels a request, and the longest kernels.  Weights
are random, from a seed.  Needs one CUDA device and ``nvcc``; there is no
CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.edgenext_s import CONFIG
from repro_torch.kernels import ref
from repro_torch.models import edgenext
from repro_torch.models.params import init_params
from repro_torch.runtime.capture import captured
from repro_torch.serve_edgenext import serve

# the hand-written kernels' names in csrc/*.cu
OURS = ("ibn_kernel", "ibn_reduce_kernel", "dw_kernel", "rows_kernel",
        "online_kernel", "matmul_ln_kernel", "wkv_states_kernel",
        "wkv_outputs_kernel", "attn_bwd_delta_kernel", "attn_bwd_dkv_kernel",
        "attn_bwd_dq_kernel")
SEED = 0


def host_ms(model, images, n: int) -> list[float]:
    out = []
    with torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(images)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def trace(model, images, n: int, inference: bool = True) -> dict:
    """``n`` calls of ``model(images)`` under ``torch.profiler``: the
    window, the device's busy time and share, the port's own kernels' time
    and the top kernels.  ``inference=False`` keeps autograd on (a train
    step)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(inference):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(images)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    busy = sum(k[1] for k in kernels)
    ours = sum(k[1] for k in kernels if any(o in k[0] for o in OURS))
    return dict(
        traced_requests=n, window_ms=window_ms, device_busy_ms=busy,
        device_busy_share=busy / window_ms if window_ms else None,
        own_kernels_ms=ours, own_kernels_share_of_busy=ours / busy if busy else None,
        device_kernel_launches=sum(k[2] for k in kernels),
        top=[dict(name=k[0][:90], ms=k[1], count=k[2]) for k in kernels[:12]])


def report(label: str, unit: str, rec: dict) -> None:
    """Prints one form's times and trace."""
    print(f"{label}: ms events median {rec['event_ms_median']:.3f} "
          f"[{rec['event_ms_min']:.3f}, {rec['event_ms_max']:.3f}]"
          + (f" host median {rec['host_ms_median']:.3f} [{rec['host_ms_min']:.3f}, "
             f"{rec['host_ms_max']:.3f}]" if "host_ms_median" in rec else ""))
    if not rec["device_busy_ms"]:
        print("  torch.profiler shows no device time here")
        return
    n = rec["traced_requests"]
    print(f"  traced {n} {unit} in {rec['window_ms']:.2f} ms: device busy "
          f"{rec['device_busy_ms']:.2f} ms "
          f"({100 * rec['device_busy_share']:.1f} %, idle "
          f"{100 * (1 - rec['device_busy_share']):.1f} %), own kernels "
          f"{rec['own_kernels_ms']:.2f} ms "
          f"({100 * rec['own_kernels_share_of_busy']:.1f} % of busy), "
          f"{rec['device_kernel_launches']} device kernels "
          f"({rec['device_kernel_launches'] / n:.0f} a step)")
    for k in rec["top"]:
        print(f"    {k['ms']:9.3f} ms  x{k['count']:<5d} {k['name']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--traced", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="run the plain versions instead of the kernels")
    ap.add_argument("--out")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("profile_edgenext: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    print(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = CONFIG
    params = init_params(SEED, edgenext.param_defs(cfg), perturb=0.05)
    model = edgenext.EdgeNeXt(
        cfg, params, kernels=ref.PLAIN if args.plain else edgenext.ops).eval()
    rng = np.random.default_rng(SEED + 1)
    results = dict(device=smi, torch=torch.__version__, plain=args.plain, batches={})
    for b in args.batches:
        images = torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, cfg.in_channels),
            dtype=np.float32)).cuda()
        forms = {}
        for form, fn in (("eager", model), ("captured", captured(model))):
            serve(fn, [images] * 3)                      # warm-up (a capture)
            _, ev_ms = serve(fn, [images] * args.requests)
            h_ms = host_ms(fn, images, args.requests)
            forms[form] = rec = dict(
                event_ms_median=statistics.median(ev_ms), event_ms_min=min(ev_ms),
                event_ms_max=max(ev_ms), host_ms_median=statistics.median(h_ms),
                host_ms_min=min(h_ms), host_ms_max=max(h_ms),
                **trace(fn, images, args.traced))
            report(f"B={b} {form}", "requests", rec)
        results["batches"][str(b)] = forms
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
