"""Serving launcher of the port: batched prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      [--reduced] [--batch 4] [--prompt-len 64] [--gen 32] [--seed 0] \
      [--device cuda|cpu]

Port of ``repro/launch/serve.py`` for every ported arch (``configs.ARCHS``:
RWKV-6, the dense and MoE transformers, Qwen2-VL, the Seamless
encoder-decoder and the RecurrentGemma hybrid).  Weights come from
``--seed``: on the card drawn there (the model's ``init_on_device``, as
the reference jits its ``init_params`` onto the device: the uncut
starcoder2-15b's 16 B parameters in seconds, and no float32 copy of a
leaf made whole), on the CPU ``params.init_params`` (numpy); the two
give other numbers.  Prompts come from
``np.random.default_rng(seed)`` (and, where the config takes embedding
inputs, the prompt's ``inputs_embeds`` drawn after the tokens: for the
encoder-decoder they are the source frames, the tokens' first column is
the decoder's prefix and its self cache is sized for prompt + gen), and
decode starts from token 0, as in the JAX launcher.  ``--device``
defaults to ``cuda`` and the run raises where there is no card;
``--device cpu`` runs the plain versions on the CPU.

On the card the steps are captured, as the reference jits them: the
prefill as ``captured(partial(prefill, params))`` and the decode step as
``captured(partial(donating(decode, 1), params))`` (``jax.jit(decode,
donate_argnums=(1,))``), both in one graph pool (``runtime.capture``).
Both are captured for the run's (B, S) and B before the timed calls, and
the capture's host seconds are printed on a line of their own.  The
printed prefill ms and ms/token are then the replays', timed with CUDA
events.  This is one deliberate difference from the reference, whose
``t_prefill`` (and first decode step) include the compile.  On the CPU the
eager steps run, timed by the host clock.  One device, no mesh: serving
under a mesh (``runtime.pipeline.data_parallel``'s fan-out, the 'tp'
profile's specs) is ROADMAP queue 1 item 8c.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_module
from repro_torch.models.params import init_params
from repro_torch.runtime import build_decode_step, build_prefill_step
from repro_torch.runtime.capture import captured, donating


def timed(fn: Callable, device: torch.device):
    """(fn(), milliseconds): CUDA events on the card, host clock else."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _prefill(cfg: ModelConfig, params) -> Callable:
    """prefill(batch, decode_len=None) with ``params`` bound: the step
    ``build_prefill_step(cfg, decode_len=decode_len)`` builds.  Captured,
    it keeps one graph for each value of ``decode_len``, as it does for
    each shape."""
    def prefill(batch, decode_len=None):
        return build_prefill_step(cfg, decode_len=decode_len)(params, batch)
    return prefill


def eager_steps(cfg: ModelConfig, params) -> Tuple[Callable, Callable]:
    """(prefill(batch, decode_len=None), decode(cache, batch)): the eager
    steps with ``params`` bound."""
    return _prefill(cfg, params), functools.partial(build_decode_step(cfg), params)


def captured_steps(cfg: ModelConfig, params) -> Tuple[Callable, Callable]:
    """The same steps captured, as the reference jits them: the prefill,
    and the decode step with its cache donated; one graph pool."""
    pool = torch.cuda.graph_pool_handle()
    decode = donating(build_decode_step(cfg), 1)
    return (captured(_prefill(cfg, params), pool=pool),
            captured(functools.partial(decode, params), pool=pool))


def call_prefill(prefill: Callable, batch: dict, decode_len: Optional[int] = None):
    """``prefill(batch)``, or ``prefill(batch, decode_len)`` where there is a
    ``decode_len``: one way of calling for each, so that a captured prefill
    sees one signature (and keeps one graph) whoever calls it."""
    return prefill(batch) if decode_len is None else prefill(batch, decode_len)


def run_prefill(prefill: Callable, tokens: torch.Tensor,
                inputs_embeds: Optional[torch.Tensor] = None,
                decode_len: Optional[int] = None, *,
                positions: Optional[torch.Tensor] = None):
    """``call_prefill`` on tokens [B, S] (and ``inputs_embeds`` [B, S, D],
    M-RoPE ``positions`` [3, B, S] where given) -> (last hidden [B, D],
    cache, ms)."""
    batch = {"tokens": tokens}
    if inputs_embeds is not None:
        batch["inputs_embeds"] = inputs_embeds
    if positions is not None:
        batch["positions"] = positions
    with torch.inference_mode():
        (last, cache), ms = timed(lambda: call_prefill(prefill, batch, decode_len),
                                  tokens.device)
    return last, cache, ms


def run_decode(decode: Callable, cache, batch: int, gen: int,
               device: torch.device
               ) -> Tuple[torch.Tensor, List[torch.Tensor], object, float]:
    """``gen`` greedy steps of ``decode(cache, batch)`` from token 0 ->
    (tokens [B, gen] int32, logits of each step [B, Vp], the last cache, ms
    for all steps)."""
    def loop(cache):
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        toks, logits = [], []
        for _ in range(gen):
            tok1, lg, cache = decode(cache, {"tokens": tok})
            tok = tok1[:, None]
            toks.append(tok1)
            logits.append(lg)
        return torch.stack(toks, 1), logits, cache

    with torch.inference_mode():
        (toks, logits, cache), ms = timed(lambda: loop(cache),
                                          torch.device(device))
    return toks, logits, cache, ms


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels, steps "
                         "captured as CUDA graphs) or cpu (the plain "
                         "versions, eager)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: --device cuda (the default) but no CUDA "
                           "device is available; pass --device cpu to run "
                           "the plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mod = get_module(cfg)
    tree = (mod.init_on_device(cfg, args.seed, device=device) if device.type == "cuda"
            else init_params(args.seed, mod.param_defs(cfg)))
    params = mod.load_params(cfg, tree, device=device)
    del tree

    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)).to(device)
    embeds = None
    if cfg.embedding_inputs:
        embeds = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(device)
        if cfg.family == "audio":
            tokens = tokens[:, :1]
    total = S + args.gen if cfg.family == "audio" else None
    if device.type == "cuda":
        prefill, decode = captured_steps(cfg, params)
        # capture both at the run's shapes (the first call at a signature
        # captures it) before the timed calls
        _, cache, _ = run_prefill(prefill, tokens, embeds, total)
        run_decode(decode, cache, B, 1, device)
        print(f"capture prefill[{B}x{S}]={prefill.capture_s[0]:.2f}s "
              f"decode[{B}]={decode.capture_s[0]:.2f}s (host clock)")
    else:
        prefill, decode = eager_steps(cfg, params)
    _, cache, t_prefill = run_prefill(prefill, tokens, embeds, total)
    gen, _, _, t_decode = run_decode(decode, cache, B, args.gen, device)
    gen = gen.cpu().numpy()
    print(f"arch={cfg.name} device={device} prefill[{B}x{S}]={t_prefill:.1f}ms "
          f"decode {args.gen} steps={t_decode:.1f}ms "
          f"({t_decode / max(args.gen, 1):.2f} ms/tok)")
    print("generated (first seq):", gen[0][:16].tolist())
    return {"tokens": gen, "prefill_ms": t_prefill,
            "decode_ms_per_token": t_decode / max(args.gen, 1)}


if __name__ == "__main__":
    main()
