"""Training launcher of the port: any ``--arch`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \
      --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Port of ``repro/launch/train.py``: config -> model -> float32 master
weights (``requires_grad``) and AdamW state -> the deterministic synthetic
data (``data.synthetic``) -> ``runtime.build_train_step`` -> a loop with the
straggler watchdog, asynchronous checkpoints every ``--ckpt-every`` steps
and at the end, and crash-resume from ``--ckpt-dir`` at the exact step and
batch.  Weights come from ``--seed`` (``params.init_params``, numpy; not
the reference's random numbers).  ``--device`` defaults to ``cuda`` (the
hand-written kernels, the attention backward included; raises where there
is no card); ``--device cpu`` runs the plain versions.  One device: the
reference's ``--production-mesh`` and its sharding belong to the
distributed runtime (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.synthetic import make_dataset
from repro_torch.models import get_module
from repro_torch.models.params import count_params, init_params, tree_map
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.runtime import build_train_step
from repro_torch.runtime.watchdog import StragglerWatchdog


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ibn-chunks", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: --device cuda (the default) but no CUDA "
                           "device is available; pass --device cpu to run "
                           "the plain versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mod = get_module(cfg)

    shape = ShapeConfig("train_4k", "train", args.seq, args.batch)
    ds = make_dataset(cfg, shape, seed=args.seed)

    defs = mod.param_defs(cfg)
    print(f"arch={cfg.name} params={count_params(defs)/1e6:.1f}M "
          f"device={device}")

    params = tree_map(
        lambda a, path: torch.from_numpy(a).to(device).requires_grad_(),
        init_params(args.seed, defs))
    opt_state = adamw_init(params)

    step0 = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            step0, restored = restore(
                args.ckpt_dir, {"params": params, "opt": opt_state}, device)
            params, opt_state = restored["params"], restored["opt"]
            print(f"resumed from step {step0}")

    train_step = build_train_step(
        cfg, lr_schedule=warmup_cosine(args.lr, args.warmup, args.steps),
        ibn_chunks=args.ibn_chunks)

    watchdog = StragglerWatchdog(
        on_escalate=lambda msg: print(f"[watchdog] ESCALATE: {msg}"))

    for step in range(step0, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch(step).items()}
        watchdog.start()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = watchdog.stop(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"dt={dt*1e3:.0f}ms")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    print("done")


if __name__ == "__main__":
    main()
