"""Quickstart: train a tiny LM, checkpoint it, resume it, sample from it: the
port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--steps N]

The example's five steps, with its constants: (1) ``h2o-danube-1.8b`` at
``reduced`` size (float32); (2) ``data.synthetic`` batches of 8 x 64 tokens
(seed 0, a bigram language, so the loss can fall); (3)
``runtime.build_train_step`` with ``warmup_cosine(2e-3, 10, 120)`` for
``--steps`` steps (120), the loss printed every 20 steps, and
``checkpoint.AsyncCheckpointer`` saving parameters and AdamW moments every
60 steps (or every ``--steps`` where that is fewer, so that a short run has
a save to resume from); (4) the last save restored (``checkpoint.restore``);
(5) a prefill of ``batch(999)``'s first 2 x 32 tokens with ``decode_len``
48, then 16 greedy decode steps from the prompt's last token on the restored
weights, printed as the example prints them (``generated:``, ``bigram
consistency:``).  The weights come from seed 0 (``params.init_params``,
numpy: not the JAX example's random numbers; ``run`` takes any tree, the
JAX package's carried across by ``from_jax_params`` among them).  On the
card (the default; raises where there is none) every attention call,
forward and backward, and every leaf's AdamW update is a hand-written
kernel, and the steps are captured as the example jits them: the train
step by ``runtime.capture.captured_train_step`` (its state donated; steps
0 and 1 eager, step 2 captured, the rest replayed), the prefill and the
decode step by ``launch.serve.captured_steps``.  ``--device cpu`` runs the
plain versions, eagerly.
"""
from __future__ import annotations

import argparse
import functools
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.synthetic import make_dataset
from repro_torch.models import get_module
from repro_torch.models.params import (count_params, from_jax_params, init_params,
                                       tree_map)
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.launch.serve import call_prefill, captured_steps
from repro_torch.runtime import (build_decode_step, build_prefill_step,
                                 build_train_step, captured_train_step)

# the example's arch, shape (train_4k cut to 8 rows of 64 tokens), seeds,
# schedule, steps, logging and checkpoint cadence, and its prompt
ARCH = "h2o-danube-1.8b"
SHAPE = ShapeConfig("train_4k", "train", 64, 8)
DATA_SEED, PARAM_SEED = 0, 0
LR, WARMUP, DECAY = 2e-3, 10, 120
STEPS = 120
LOG_EVERY, CKPT_EVERY = 20, 60
PROMPT_STEP, PROMPT_ROWS, PROMPT_LEN = 999, 2, 32
DECODE_LEN, GEN = 48, 16


def config():
    """The example's model: ``h2o-danube-1.8b`` at ``reduced`` size."""
    return reduced(get_config(ARCH))


def generate(cfg, params, tokens: torch.Tensor, *, kernels=None,
             tokens_in: Optional[torch.Tensor] = None):
    """Step 5: prefill ``tokens`` [B, S] (``decode_len`` DECODE_LEN), then GEN
    greedy decode steps from the prompt's last token -> (last hidden [B, D],
    tokens [B, GEN] int32, each step's logits [B, Vp]).  ``kernels`` as the
    step builders take it (the plain versions: ``kernels.ref.PLAIN``), their
    default where None.  ``tokens_in`` [B, GEN]: teacher-forced decode, step
    i + 1 fed ``tokens_in[:, i]`` instead of step i's greedy token.  On
    the card with the default kernels both steps are captured
    (``launch.serve.captured_steps``)."""
    if kernels is None and tokens.is_cuda:
        prefill, decode = captured_steps(cfg, params)
    else:
        kw = {} if kernels is None else {"kernels": kernels}
        step = build_prefill_step(cfg, decode_len=DECODE_LEN, **kw)
        prefill = lambda batch, decode_len: step(params, batch)  # noqa: E731
        decode = functools.partial(build_decode_step(cfg, **kw), params)
    with torch.inference_mode():
        last, cache = call_prefill(prefill, {"tokens": tokens}, DECODE_LEN)
        tok = tokens[:, -1:]
        toks, logits = [], []
        for i in range(GEN):
            tok1, lg, cache = decode(cache, {"tokens": tok})
            tok = (tok1 if tokens_in is None else tokens_in[:, i])[:, None]
            toks.append(tok1)
            logits.append(lg)
    return last, torch.stack(toks, 1), logits


def run(params=None, *, steps: int = STEPS, ckpt_every: int = CKPT_EVERY,
        device: "torch.device | str" = "cuda", out: Callable = print) -> dict:
    """The example's loop: ``steps`` train steps from ``params`` (a float32
    tree of ``config()`` on ``device``, updated in place; seed 0's where
    None), a save of {"params", "opt"} after every ``ckpt_every``-th step
    into a temporary directory (removed at the end), the last save
    restored, then ``generate`` on the restored parameters.  Prints the
    example's lines through ``out`` and returns
    {"cfg", "losses" (each step's), "params" / "opt" (the run's last
    state), "saved_step", "restored" (the tree read back), "prompt",
    "last_hidden", "generated", "logits", "bigram_hits", "train_step" (the
    step run: ``captured_train_step``'s on the card)}."""
    device = torch.device(device)
    cfg = config()
    mod = get_module(cfg)
    out(f"arch={cfg.name} family={cfg.family} "
        f"params={count_params(mod.param_defs(cfg)) / 1e6:.2f}M (reduced)")
    ds = make_dataset(cfg, SHAPE, seed=DATA_SEED)
    if params is None:
        defs = mod.param_defs(cfg)
        params = from_jax_params(init_params(PARAM_SEED, defs), defs, device=device)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, lr_schedule=warmup_cosine(LR, WARMUP, DECAY))
    if device.type == "cuda":
        step_fn = captured_train_step(step_fn)
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt_dir:
        ck = AsyncCheckpointer(ckpt_dir)
        losses, saved = [], None
        for step in range(steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in ds.batch(step).items()}
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            if step % LOG_EVERY == 0:
                out(f"step {step:4d} loss={losses[-1]:.3f}")
            if (step + 1) % ckpt_every == 0:
                ck.save(step + 1, {"params": params, "opt": opt})
                saved = step + 1
        ck.wait()

        # 4. crash-resume: read the last save back onto the device
        def bare(tree):
            return tree_map(lambda t, path: t.detach(), tree)
        like = {"params": bare(params), "opt": opt._replace(m=bare(opt.m), v=bare(opt.v))}
        step0, restored = restore(ckpt_dir, like, device)
    out(f"restored checkpoint at step {step0}")

    # 5. serve: prefill a prompt, greedy-decode GEN tokens
    prompt = torch.from_numpy(ds.batch(PROMPT_STEP)["tokens"][:PROMPT_ROWS, :PROMPT_LEN]
                              ).to(device)
    last, generated, logits = generate(cfg, restored["params"], prompt)
    seq = generated.cpu().numpy()
    out(f"generated: {seq[0].tolist()}")
    # the bigram language is deterministic: a trained model should often
    # predict perm[token]
    hits = sum(int(seq[0, i + 1] == int(ds.perm[seq[0, i]])) for i in range(GEN - 1))
    out(f"bigram consistency: {hits}/{GEN - 1}")
    return dict(cfg=cfg, losses=losses, params=params, opt=opt, saved_step=saved,
                restored_step=step0, restored=restored, prompt=prompt,
                last_hidden=last, generated=generated, logits=logits,
                bigram_hits=hits, train_step=step_fn)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("quickstart: --device cuda (the default) but no "
                           "CUDA device is available; pass --device cpu to run "
                           "the plain versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(steps=args.steps, ckpt_every=min(CKPT_EVERY, args.steps), device=device)
    if not np.isfinite(res["losses"]).all():
        raise RuntimeError(f"quickstart: losses {res['losses']}")
    return res


if __name__ == "__main__":
    main()
