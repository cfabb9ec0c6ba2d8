"""Inference steps: port of ``repro/runtime/steps.py``'s prefill and
greedy decode.  Training (``build_train_step``, ``loss_from_logits``) is
ROADMAP queue 1 item 7.

``kernels`` is the namespace the model's kernel calls go through:
``ops`` (the default) or ``ref.PLAIN`` for the same composition without
any kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import get_module


def build_prefill_step(cfg: ModelConfig, *, decode_len: Optional[int] = None,
                       kernels=ops) -> Callable:
    """(params, batch) -> (last_hidden [B,D], cache).  ``decode_len`` sizes
    the encoder-decoder's self-attention cache (the audio family only, as
    in the reference)."""
    mod = get_module(cfg)
    kw = {"decode_len": decode_len} if cfg.family == "audio" \
        and decode_len is not None else {}

    def prefill_step(params, batch):
        return mod.prefill(cfg, params, batch, kernels=kernels, **kw)

    return prefill_step


def build_decode_step(cfg: ModelConfig, *, kernels=ops) -> Callable:
    """(params, cache, batch) -> (token [B] int32, logits [B,Vp], cache):
    greedy, with the padded vocabulary masked before the argmax."""
    mod = get_module(cfg)

    def decode_step(params, cache, batch):
        logits, cache = mod.decode_step(cfg, params, cache, batch,
                                        kernels=kernels)
        vp = logits.shape[-1]
        if vp != cfg.vocab_size:
            pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad[None, :], float("-inf"))
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        return token, logits, cache

    return decode_step
