"""The paper, end to end: EdgeNeXt-S through the scheduling stack and onto
the port's kernels.

    PYTHONPATH=src python -m repro_torch.edge_schedule [--device cpu]

Two parts:

1. The cost model of the paper's 28 nm edge accelerator, pure Python: the
   Fig 8 optimisation stack, the IBN share of DRAM traffic (Fig 5), the
   fusion tile, Table I, and the auto-scheduler, which must rediscover
   C1-C3 from enumeration alone.  These are outputs of the model, not
   times of any chip, and equal the JAX package's
   ``examples/edge_schedule.py`` line for line.
2. The searched schedule lowered onto the kernels at full EdgeNeXt-S
   width and batch 1, with seeded weights: every lowered ``fused_ibn``
   entry of the first stage (bias folded, as the model does it) against
   the model's IBN MLP run through the plain versions, every lowered
   ``matmul_ln`` entry (``s1..s3.sdta0.proj + ln_m``) against
   ``matmul_ln_ref``, and the 5x5 depthwise convolution of the second
   stage against its plain version; one ``max|delta|`` line each.  This
   part runs on the card (``--device cuda``, the default, raises if there
   is none) or on the CPU (``--device cpu``), where every entry point
   takes its plain version.
"""
from __future__ import annotations

import argparse
import re
from typing import List

import numpy as np
import torch

from repro_torch.configs.edgenext_s import CONFIG
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.fusion import ibn_dram_share, optimize_tile
from repro_torch.core.schedule import evaluate_stack, normalized_stack
from repro_torch.core.workload import edgenext_workload, ibn_groups, total_macs
from repro_torch.kernels import ops, ref
from repro_torch.models import edgenext
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.search import Schedule, auto_schedule, lower

SEED = 0


def cost_model_lines(wl, hw: HWSpec, sched: Schedule) -> List[str]:
    """The cost-model half of the report, one printed line each."""
    out = [f"EdgeNeXt-S: {len(wl)} layers, {total_macs(wl)/1e9:.2f} GMACs, "
           f"{len(ibn_groups(wl))} inverted bottlenecks",
           f"accelerator: {hw.rows}x{hw.cols} PEs @ {hw.clock_hz/1e6:.0f}MHz"
           f" -> {hw.peak_macs_per_s/1e9:.1f} GMAC/s, "
           f"peak {hw.peak_tops_per_w:.2f} TOPS/W (paper: 1.39)",
           "\n-- Fig 8: optimization stack (normalized to baseline) --"]
    for r in normalized_stack(wl, hw):
        out.append(f"  {r['config']:15s} latency={r['latency']:.3f} "
                   f"energy={r['energy']:.3f} edp={r['edp']:.3f} "
                   f"fps={r['fps']:6.2f}")
    share = ibn_dram_share(wl, hw.act_budget_bytes)
    out.append(f"\n-- Fig 5 -- IBN share of DRAM traffic: {100*share:.1f}% "
               f"(paper: 63.6%)")
    exp, _, proj = ibn_groups(wl)[0]
    tile = optimize_tile(exp, proj, local_buffer=hw.output_rf_bytes)
    out.append(f"   fusion tile (ZigZag-style search): x={tile.tile_x} "
               f"c={tile.tile_c} buffer={tile.buffer_bytes}B "
               f"<= RF {hw.output_rf_bytes}B")
    final = evaluate_stack(wl, hw)[-1].cost
    out.append(f"\n-- Table I -- fps={final.fps:.2f} (paper 13.16), "
               f"chip power={final.chip_power_w*1e3:.1f}mW (paper 18.4), "
               f"FPS/W={final.fps_per_w_chip:.0f} (paper 731)")
    out += ["\n-- repro_torch.search auto-scheduler --",
            f"  groups={len(sched.groups)} spill_edges={len(sched.edges)} "
            f"fused_nonlinear={len(sched.fused_nonlinear)}",
            f"  auto edp={sched.cost['edp']:.4g} vs hand "
            f"+ibn-fusion edp={final.edp:.4g} "
            f"(ratio {sched.cost['edp']/final.edp:.3f} <= 1)"]
    ibn_lowered = {k: v for k, v in sched.lowered.items()
                   if v["kernel"] == "fused_ibn"}
    k0 = sorted(ibn_lowered)[0]
    out.append(f"  lowered fused_ibn [{k0}]: "
               f"block_m={ibn_lowered[k0]['block_m']} "
               f"block_f={ibn_lowered[k0]['block_f']}")
    return out


def _block_params(params, layer_name: str):
    """The parameters of the block a layer name such as
    ``s1.sdta0.proj`` belongs to."""
    si, kind, bi = re.match(r"s(\d+)\.(conv|sdta)(\d+)\.", layer_name).groups()
    return params["stages"][int(si)][f"{kind}_blocks"][int(bi)]


def _max_delta(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def kernel_lines(wl, sched: Schedule, device: str) -> List[str]:
    """Every lowered fused_ibn entry of the first stage and every lowered
    matmul_ln entry through its kernel with the lowered blocks, and the
    5x5 depthwise convolution, each against its plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    defs = edgenext.param_defs(CONFIG)
    params = from_jax_params(init_params(SEED, defs, perturb=0.05), defs,
                             device=device)
    rng = np.random.default_rng(SEED + 1)

    def randn(*shape: int) -> torch.Tensor:
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(device)

    out = [f"\n-- kernels on {device}: EdgeNeXt-S at full width, batch 1 --"]
    for key, lk in sorted(sched.lowered.items()):
        shape = lower.launch_shape(wl, key, lk)
        rows = shape.get("m")
        if lk["kernel"] == "fused_ibn" and key.startswith("s0."):
            bp = _block_params(params, key)
            x = randn(rows, shape["d"])
            ones = torch.ones((rows, 1), device=device)
            got = ops.fused_ibn(
                torch.cat([x, ones], -1),
                torch.cat([bp["pw1_w"], bp["pw1_b"][None]], 0), bp["pw2_w"],
                block_m=lk["block_m"], block_f=lk["block_f"]) + bp["pw2_b"]
            want = edgenext._ibn_mlp(bp, x, kernels=ref.PLAIN)
            out.append(f"  C3 fused_ibn [{key}] M={rows} "
                       f"(block_m={lk['block_m']} block_f={lk['block_f']}) "
                       f"vs model IBN: max|delta| = "
                       f"{_max_delta(got, want):.2e}")
        elif lk["kernel"] == "matmul_ln":
            bp = _block_params(params, key)
            x = randn(rows, shape["k"])
            args = (x, bp["proj_w"], bp["proj_b"], bp["ln_m"]["scale"],
                    bp["ln_m"]["bias"])
            got = ops.matmul_ln(*args, block_m=lk["block_m"],
                                block_k=lk["block_k"])
            out.append(f"  C2 matmul_ln [{key}] M={rows} K={shape['k']} "
                       f"N={shape['n']} (block_m={lk['block_m']} "
                       f"block_k={lk['block_k']}) "
                       f"vs matmul_ln_ref: max|delta| = "
                       f"{_max_delta(got, ref.matmul_ln_ref(*args)):.2e}")
    res = CONFIG.img_size // 8
    bp = params["stages"][1]["conv_blocks"][0]
    xi = randn(1, res, res, CONFIG.dims[1])
    got = ops.depthwise_conv2d(xi, bp["dw_w"], bp["dw_b"])
    want = ref.depthwise_conv2d_ref(xi, bp["dw_w"], bp["dw_b"])
    out.append(f"  C1 C|FX depthwise {CONFIG.kernel_sizes[1]}x"
               f"{CONFIG.kernel_sizes[1]} [1x{res}x{res}x{CONFIG.dims[1]}] vs "
               f"plain: max|delta| = {_max_delta(got, want):.2e}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel part runs (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel part runs on the card, "
                           "or on the CPU with --device cpu")
    wl = edgenext_workload(CONFIG)
    hw = HWSpec()
    sched = auto_schedule(wl, hw, workload="edgenext-s")
    for line in cost_model_lines(wl, hw, sched):
        print(line)
    for line in kernel_lines(wl, sched, args.device):
        print(line, flush=True)


if __name__ == "__main__":
    main()
