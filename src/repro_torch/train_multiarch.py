"""Train every architecture family for a few steps on one loop: the port
of ``examples/train_multiarch.py``, the composability demo (the same train
step builder, data pipeline and optimizer across dense / MoE / VLM /
hybrid / SSM / enc-dec).

    PYTHONPATH=src python -m repro_torch.train_multiarch [--device cpu] \
        [--steps N] [--arch A ...]

Each arch of ``configs.ARCHS`` (or of ``--arch``) at ``reduced`` size
(float32) trains ``--steps`` steps (12) of ``runtime.build_train_step``
(remat, AdamW, clip 1.0, ``warmup_cosine(1e-3, 5, 30)``) over
``data.synthetic`` batches of 4 x 48 tokens (seed 1), as the example
does, and prints its line: ``arch [family] loss first -> last``.  The
weights come from seed 0 (``params.init_params``, numpy: not the JAX
example's random numbers; ``train_arch`` takes any tree, the JAX
package's carried across by ``from_jax_params`` among them).  On the card
(the default; raises where there is none) every attention and WKV call,
forward and backward, and every leaf's AdamW update is a hand-written
kernel, and the step is captured as the example jits it
(``runtime.capture.captured_train_step``: steps 0 and 1 eager, step 2
captured, the rest replayed); ``--device cpu`` runs their plain versions,
eagerly.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ARCHS, ShapeConfig, get_config, reduced
from repro_torch.data.synthetic import make_dataset
from repro_torch.models import get_module
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.runtime import build_train_step, captured_train_step

# the example's shape (train_4k cut to 4 rows of 48 tokens), schedule,
# steps and seeds
SHAPE = ShapeConfig("train_4k", "train", 48, 4)
LR, WARMUP, DECAY = 1e-3, 5, 30
STEPS = 12
DATA_SEED, PARAM_SEED = 1, 0


def train_arch(cfg, params, *, steps: int = STEPS,
               device: "torch.device | str" = "cuda") -> List[float]:
    """The example's inner loop: ``steps`` train steps of ``cfg`` from
    ``params`` (a float32 tree of tensors on ``device``, updated in place)
    over the synthetic batches -> each step's loss."""
    ds = make_dataset(cfg, SHAPE, seed=DATA_SEED)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, lr_schedule=warmup_cosine(LR, WARMUP, DECAY))
    if torch.device(device).type == "cuda":
        step_fn = captured_train_step(step_fn)
    losses = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in ds.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses


def run(arch: str, *, steps: int = STEPS,
        device: "torch.device | str" = "cuda") -> List[float]:
    """``arch`` at ``reduced`` size from seed 0's weights through
    ``train_arch`` -> each step's loss."""
    cfg = reduced(get_config(arch))
    defs = get_module(cfg).param_defs(cfg)
    params = from_jax_params(init_params(PARAM_SEED, defs), defs, device=device)
    return train_arch(cfg, params, steps=steps, device=device)


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", choices=sorted(ARCHS), default=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_multiarch: --device cuda (the default) but no "
                           "CUDA device is available; pass --device cpu to run "
                           "the plain versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in args.arch:
        losses = run(arch, steps=args.steps, device=device)
        family = get_config(arch).family
        print(f"{arch:24s} [{family:6s}] loss {losses[0]:7.3f} -> {losses[-1]:7.3f}",
              flush=True)
        out[arch] = losses
    return out


if __name__ == "__main__":
    main()
