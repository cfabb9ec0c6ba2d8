"""The request loop of EdgeNeXt classification: nothing but the loop.

``serve(model, batches)`` answers a list of image batches one after the
other under ``torch.inference_mode()`` and times each: with CUDA events
on the card (the device's time for the request), with the host clock on
the CPU.  ``model`` is any callable from images to logits: an ``EdgeNeXt``
or, on the card, ``runtime.capture.captured(model)``, which replays the
forward as a CUDA graph.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import torch


def serve(model: Callable[[torch.Tensor], torch.Tensor],
          batches: Sequence[torch.Tensor]
          ) -> Tuple[List[torch.Tensor], List[float]]:
    """batches: each [B, img, img, 3] on the model's device.
    Returns (logits per request, milliseconds per request)."""
    logits: List[torch.Tensor] = []
    ms: List[float] = []
    with torch.inference_mode():
        for images in batches:
            if images.is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = model(images)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = model(images)
                ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(out)
    return logits, ms
