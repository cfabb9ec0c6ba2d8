"""Int8 gradient compression with error feedback, the local half of
``repro/optim/compression.py``: quantize, dequantize, quantize with the
carried residual (so that compression error does not bias the gradient
direction), and the zero residual tree.  The compressed all-reduce across
pods (``compressed_pod_allreduce``) belongs to the distributed runtime,
ROADMAP queue 1 item 8."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_map

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale float32)."""
    absmax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_with_feedback(x: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: q(x + residual), new residual."""
    target = x.to(torch.float32) + residual
    q, scale = quantize_int8(target)
    new_residual = target - dequantize_int8(q, scale)
    return q, scale, new_residual


def init_feedback(grads: Tree) -> Tree:
    return tree_map(lambda g, path: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)
