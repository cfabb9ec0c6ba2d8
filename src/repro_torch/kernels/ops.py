"""Public entry points of the kernels, with the signatures of the JAX
package's ``repro.kernels.ops``.

Routing is by the tensor's device and by nothing else: a CPU tensor goes
to the plain version in ``ref``; a CUDA tensor launches the hand-written
kernel, or raises if it cannot be built or launched.  No flag, no
fallback.

The ``block_*`` keywords are accepted so that launch parameters lowered
from a schedule still splat in.  The Hopper kernels choose their own
tiles (they take the true extents and mask ragged edges themselves), so
the values are ignored here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ibn as _ibn
from repro_torch.kernels import ref


def fused_ibn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              wg: Optional[torch.Tensor] = None, *, activation: str = "gelu",
              block_m: int = 256, block_f: int = 512) -> torch.Tensor:
    """act(x @ w1 [* gate]) @ w2 for x of any leading shape [..., D]."""
    if not x.is_cuda:
        return ref.fused_ibn_ref(x, w1, w2, wg, activation=activation)
    lead = x.shape[:-1]
    # view, not reshape: a layout that would need a copy raises here
    out = _ibn.fused_ibn(x.view(-1, x.shape[-1]), w1, w2, wg,
                         activation=activation)
    return out.reshape(*lead, w2.shape[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention; q: [B,H,Sq,D], k, v: [B,H,Sk,D]."""
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     block_c: int = 128) -> torch.Tensor:
    """Channels-last SAME depthwise conv; x: [B,H,W,C], w: [fy,fx,C]."""
    if not x.is_cuda:
        return ref.depthwise_conv2d_ref(x, w, b)
    return _dw.depthwise_conv2d(x, w, b)
