"""Batched serving across model families: prefill + greedy decode with each
family's cache (KV ring buffer / RWKV state / RG-LRU + conv state /
encoder-decoder): the port of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.serve_lm [--device cpu] [--arch A ...]

For each of the example's five archs (``ARCHS``: dense MHA, MoE top-8,
attention-free, hybrid RG-LRU, encoder-decoder) at ``reduced`` size,
``serve`` draws a batch of 4 prompts of 48 tokens from
``np.random.default_rng(7)`` (with ``inputs_embeds`` drawn after the tokens
where the config takes embedding inputs; the encoder-decoder keeps the
tokens' first column as its decoder prefix), runs
``runtime.build_prefill_step(cfg, decode_len=48 + 24)`` and then 24 greedy
``build_decode_step`` steps from token 0, and prints the example's line:
prefill ms, decode ms a token, and the first sequence's first 8 tokens.
The reference's behaviours are kept: a dense model's cache is the prompt's
length and the decode writes past it clamp to its last slot, and an MoE
decode of 4 tokens drops the claims past an expert's capacity of 1.  The
weights come from seed 0 (``params.init_params``, numpy: not the JAX
example's random numbers; ``serve`` takes any tree, the JAX package's
among them).  On the card (the default; raises where there is none) every
prefill's attention and WKV call is a hand-written kernel, and the steps
are captured as the example jits them (``launch.serve.captured_steps``:
the prefill, and the decode step with its cache donated), timed by the
host clock after ``torch.cuda.synchronize()`` where the example waits with
``block_until_ready``: the prefill's time includes its capture, as the
example's includes the compile.  ``--device cpu`` runs the plain versions,
eagerly.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import get_module
from repro_torch.models.params import init_params
from repro_torch.launch.serve import call_prefill, captured_steps
from repro_torch.runtime import build_decode_step, build_prefill_step

# the example's archs, batch, prompt, tokens generated and seeds
ARCHS = ("olmo-1b",                  # dense MHA
         "qwen3-moe-30b-a3b",        # MoE top-8
         "rwkv6-1.6b",               # attention-free
         "recurrentgemma-2b",        # hybrid RG-LRU
         "seamless-m4t-large-v2")    # enc-dec
BATCH, PROMPT_LEN, GEN = 4, 48, 24
DATA_SEED, PARAM_SEED = 7, 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch_size: int = BATCH, prompt_len: int = PROMPT_LEN,
          gen: int = GEN, *, device: "torch.device | str" = "cuda",
          params=None, kernels=None, tokens_in: Optional[torch.Tensor] = None,
          out=print) -> dict:
    """One arch of the example: ``arch`` at ``reduced`` size, a prefill of
    the example's prompts (tokens [B, S] int32 from ``default_rng(7)``, then
    ``inputs_embeds`` [B, S, d] where the config takes embedding inputs, the
    audio family's tokens cut to its one-token decoder prefix) and ``gen``
    greedy decode steps from token 0, the example's line printed through
    ``out`` (None: not printed).  ``params``:
    a tree of numpy arrays or tensors (seed 0's ``init_params`` where None),
    loaded by the model's ``load_params``.  ``kernels`` as the step builders
    take it (the plain versions: ``kernels.ref.PLAIN``), their default where
    None.  ``tokens_in`` [B, gen]: teacher-forced decode, step i + 1 fed
    ``tokens_in[:, i]`` instead of step i's greedy token (step 0 is fed
    token 0 either way).  Returns
    {"cfg", "batch" (the prompts on the device), "last_hidden",
    "tokens" [B, gen] int32, "logits" (each step's [B, Vp]), "prefill_ms",
    "decode_ms_per_token"}."""
    device = torch.device(device)
    cfg = reduced(get_config(arch))
    mod = get_module(cfg)
    if params is None:
        params = init_params(PARAM_SEED, mod.param_defs(cfg))
    params = mod.load_params(cfg, params, device=device)
    rng = np.random.default_rng(DATA_SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, prompt_len),
                                    dtype=np.int32)}
    if cfg.embedding_inputs:
        batch["inputs_embeds"] = rng.standard_normal(
            (batch_size, prompt_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            batch["tokens"] = batch["tokens"][:, :1]
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if kernels is None and device.type == "cuda":
        prefill, decode = captured_steps(cfg, params)
    else:
        kw = {} if kernels is None else {"kernels": kernels}
        step = build_prefill_step(cfg, decode_len=prompt_len + gen, **kw)
        prefill = lambda b, decode_len: step(params, b)  # noqa: E731
        decode = functools.partial(build_decode_step(cfg, **kw), params)

    with torch.inference_mode():
        _sync(device)
        t0 = time.monotonic()
        last, cache = call_prefill(prefill, batch, prompt_len + gen)
        _sync(device)
        t_pre = time.monotonic() - t0

        tok = torch.zeros((batch_size, 1), dtype=torch.int32, device=device)
        toks, logits = [], []
        t0 = time.monotonic()
        for i in range(gen):
            tok1, lg, cache = decode(cache, {"tokens": tok})
            tok = (tok1 if tokens_in is None else tokens_in[:, i])[:, None]
            toks.append(tok1)
            logits.append(lg)
        _sync(device)
        t_dec = time.monotonic() - t0
    toks = torch.stack(toks, 1)
    if out is not None:
        out(f"{arch:24s} [{cfg.family:6s}] prefill={t_pre * 1e3:6.0f}ms  "
            f"decode={t_dec / gen * 1e3:6.1f} ms/tok  "
            f"first-seq: {toks[0][:8].tolist()}")
    return dict(cfg=cfg, batch=batch, last_hidden=last, tokens=toks,
                logits=logits, prefill_ms=t_pre * 1e3,
                decode_ms_per_token=t_dec / gen * 1e3)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", choices=ARCHS, default=list(ARCHS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_lm: --device cuda (the default) but no CUDA "
                           "device is available; pass --device cpu to run the "
                           "plain versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return {arch: serve(arch, device=device) for arch in args.arch}


if __name__ == "__main__":
    main()
