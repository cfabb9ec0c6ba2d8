"""Optimised dry-run sweep: port of ``repro/launch/optsweep.py``, the
per-(arch x shape) sharding profiles the reference's hillclimb chose:

  train, dense-like archs : 'fsdp'  (the whole mesh as one ZeRO axis)
  train, MoE archs        : '2d'    (the experts need the model axis)
  prefill                 : '2d'    (a batch of 32 cannot fill the mesh as
                                     a dp axis; TP splits the compute)
  decode / long-context   : 'tp' + bf16 weights (the serving layout: no
                                     gathers a token; weights read in bf16)

Each cell is traced as ``launch.dryrun`` traces it, and its record is
tagged ``-opt`` beside the default profile's.

Usage:
  python -m repro_torch.launch.optsweep [--multi-pod] [--arch A] [--force]
"""
import argparse
import json

from repro_torch.configs import ARCHS, applicable_shapes, get_config
from repro_torch.launch.dryrun import (ARTIFACT_DIR, analyse_cell, cell_path,
                                       summary_line)


def cell_plan(arch: str, shape_kind: str) -> dict:
    cfg = get_config(arch)
    if shape_kind == "decode":
        return dict(profile="tp", serve_bf16=True)
    if shape_kind == "prefill":
        return dict(profile="2d", serve_bf16=False)
    if cfg.moe.enabled:
        return dict(profile="2d", serve_bf16=False)   # EP needs model axis
    return dict(profile="fsdp", serve_bf16=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    for arch in ([args.arch] if args.arch else sorted(ARCHS)):
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            out = cell_path(arch, shape.name, args.multi_pod, "opt")
            if out.exists() and not args.force:
                print(f"skip {out.name}")
                continue
            plan = cell_plan(arch, shape.kind)
            print(f"=== {arch} x {shape.name} {plan} "
                  f"({'2x16x16' if args.multi_pod else '16x16'}) ===",
                  flush=True)
            rec = analyse_cell(arch, shape.name, multi_pod=args.multi_pod,
                               extra_tag="opt", **plan)
            out.write_text(json.dumps(rec, indent=1))
            print(summary_line(rec), flush=True)


if __name__ == "__main__":
    main()
