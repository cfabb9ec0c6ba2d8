"""Training launcher of the port: any ``--arch``, on one device or on a
mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \
      --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch olmo-1b --reduced --mesh 2x2 \
      [--profile 2d|fsdp|tp|cp] [--device cpu]

Port of ``repro/launch/train.py``: config -> model -> float32 master
weights (``requires_grad``) and AdamW state -> the deterministic synthetic
data (``data.synthetic``) -> ``runtime.build_train_step`` -> a loop with the
straggler watchdog, asynchronous checkpoints every ``--ckpt-every`` steps
and at the end, and crash-resume from ``--ckpt-dir`` at the exact step and
batch.  Weights come from ``--seed`` (``params.init_params``, numpy; not
the reference's random numbers).  ``--device`` defaults to ``cuda`` (the
hand-written kernels, the attention backward and AdamW included; raises
where there is no card); ``--device cpu`` runs the plain versions.  On the
card the step is captured as the reference jits it
(``jit(train_step, donate_argnums=(0, 1))``): ``runtime.capture.
captured_train_step``, one CUDA graph of the whole step with the
parameters, moments and count donated; its first two calls run eagerly
(steps 0 and 1 of the run), the third captures and replays, and a line
``capture ...`` gives the capture's host seconds and the MiB its graph's
pool reserved.  On the CPU, and on a mesh where an axis has more than one
rank (gloo stages every collective through the host), the step runs
eager.

``--mesh DATAxMODEL`` (``launch.mesh.make_mesh`` over the world) or
``--production-mesh`` (16 x 16, 256 ranks) runs the sharded step
(``runtime.build_train_step(mesh=...)``, ``--profile``) under
``torchrun --standalone --nproc-per-node N`` or ``launch.mesh.spawn_local``
(each rank calls ``main``).  Every rank makes the same global batch as the
one-device launcher (``data.synthetic`` with one process: the reference's
``jax.process_index()`` counts hosts, not devices) and the step takes its
block, so a mesh changes no value of the run.  ``--profile`` picks the
layout (``runtime.sharding``): '2d' (the default) holds the weights as
blocks over 'data' (FSDP, gathered a layer at a time where they are used)
and splits heads, d_ff and vocabulary over 'model' (tensor parallelism: a
rank of 'model' runs its share of the products); 'tp' splits over 'model'
alike but keeps the weights whole over 'data' (plain data parallelism
there); 'fsdp' makes the whole mesh one FSDP / data-parallel axis, no
split products; 'cp' holds the weights as blocks over 'data' and splits
each row's sequence over 'model' (context parallelism: where 'model'
divides ``--seq``, a rank of 'model' runs S / n consecutive tokens, the
attention over K / V gathered from the ranks before it, a recurrence from
the state the rank before left).  Each rank initialises the
whole tree from the seed and keeps its block; checkpoints are written
once, from gathered leaves, by rank 0, and a resume reads each rank's
block (``checkpoint.restore_sharded``), from a checkpoint written under
any mesh.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    restore_sharded)
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.synthetic import make_dataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import get_module
from repro_torch.models.params import (PartitionSpec, count_params,
                                       init_params, tree_map)
from repro_torch.optim import AdamWState, adamw_init, warmup_cosine
from repro_torch.runtime import build_train_step, sharding
from repro_torch.runtime.capture import capturable, captured_train_step
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
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL: a mesh over the world's ranks")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--profile", default="2d", choices=sharding.PROFILES,
                    help="the mesh's layout: 2d (FSDP over data, TP over model), "
                         "tp (TP over model, data-parallel over data), fsdp "
                         "(the whole mesh FSDP), cp (FSDP over data, each "
                         "row's sequence split over model)")
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

    mesh = None
    if args.mesh or args.production_mesh:
        mesh_lib.init_from_env(device)
        if args.production_mesh:
            mesh = mesh_lib.make_production_mesh(device=device)
        else:
            data, model = (int(n) for n in args.mesh.lower().split("x"))
            mesh = mesh_lib.make_mesh((data, model), ("data", "model"),
                                      device=device)
        device = mesh.device
    lead = mesh is None or dist.get_rank() == 0

    shape = ShapeConfig("train_4k", "train", args.seq, args.batch)
    ds = make_dataset(cfg, shape, seed=args.seed)

    defs = mod.param_defs(cfg)
    if lead:
        print(f"arch={cfg.name} params={count_params(defs)/1e6:.1f}M "
              f"device={device}"
              + (f" mesh={mesh.sizes} profile={args.profile}" if mesh else ""))

    pspecs = (sharding.model_param_pspecs(cfg, mesh, defs, profile=args.profile)
              if mesh is not None else None)
    tree = init_params(args.seed, defs)
    if pspecs is not None:
        tree = sharding.tree_local_shard(tree, pspecs, mesh)
    params = tree_map(lambda a, path: torch.from_numpy(
        np.ascontiguousarray(a)).to(device).requires_grad_(), tree)
    del tree
    opt_state = adamw_init(params)

    step0 = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir) if lead else None
        if latest_step(args.ckpt_dir) is not None:
            like = {"params": params, "opt": opt_state}
            if mesh is None:
                step0, restored = restore(args.ckpt_dir, like, device)
            else:
                specs = {"params": pspecs, "opt": AdamWState(
                    count=PartitionSpec(), m=pspecs, v=pspecs)}
                step0, restored = restore_sharded(args.ckpt_dir, like, specs, mesh)
            params, opt_state = restored["params"], restored["opt"]
            if lead:
                print(f"resumed from step {step0}")

    train_step = build_train_step(
        cfg, lr_schedule=warmup_cosine(args.lr, args.warmup, args.steps),
        ibn_chunks=args.ibn_chunks, mesh=mesh, profile=args.profile)
    captured = device.type == "cuda" and capturable(mesh)
    if captured:
        train_step = captured_train_step(train_step)
    if lead:
        print("train step " + ("captured (one CUDA graph, the state donated)"
                               if captured else "eager"))

    def state():
        """The training state to checkpoint: whole leaves (gathered by
        every rank under a mesh; only rank 0 writes them)."""
        if mesh is None:
            return {"params": params, "opt": opt_state}
        full = lambda t: tree_map(                                   # noqa: E731
            lambda x, spec, path: sharding.gather_full(x.detach(), spec, mesh),
            t, pspecs)
        return {"params": full(params), "opt": AdamWState(
            count=opt_state.count, m=full(opt_state.m), v=full(opt_state.v))}

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
        if lead and captured and train_step.replays == 1:
            print(f"capture train_step[{args.batch}x{args.seq}]="
                  f"{train_step.capture_s:.2f}s pool={train_step.pool_mib:.0f}MiB "
                  f"(host clock, after {train_step.calls - 1} eager steps)")
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"dt={dt*1e3:.0f}ms")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tree = state()
            if ckpt:
                ckpt.save(step + 1, tree)
    if args.ckpt_dir:
        tree = state()
        if ckpt:
            ckpt.save(args.steps, tree)
            ckpt.wait()
    if mesh is not None:
        dist.barrier()
    if lead:
        print("done")


if __name__ == "__main__":
    main()
