"""Public entry points of the kernels, with the signatures of the JAX
package's ``repro.kernels.ops``.

Routing is by the tensor's device and by nothing else: a CPU tensor goes
to the plain version in ``ref``, whatever ``block_*`` it is given; a CUDA
tensor launches the hand-written kernel, or raises if it cannot be built
or launched.  No flag, no fallback.

Gradients: ``flash_attention`` goes through ``FlashAttention`` (its
backward a hand-written kernel too) where grad mode is on and q, k or v
requires grad.  The other four kernels have no backward yet: on a CUDA
tensor under grad mode with any input (weights included) that requires
grad, they raise ``RuntimeError`` before anything launches, where a fresh
output with no ``grad_fn`` would drop the gradient without a word.  On
CPU tensors the plain versions stay differentiable.

The ``block_*`` keywords are the launch parameters that
``repro_torch.search.lower`` emits, and on a CUDA tensor they are the
tiles the kernel runs: ``matmul_ln`` picks its template instance by
block_m (the rows a thread-block cluster owns) and takes block_k from its
menu onto its one K slab; ``fused_ibn`` and ``flash_attention`` are built for
one tile each, which is their default, and raise on any other.
``depthwise_conv2d`` is not lowered: its ``block_c`` is accepted for the
JAX signature and not used (the kernel's tile comes from
``depthwise_conv.plan``).  ``wkv_chunked``'s ``chunk`` is the searched
schedule parameter and is run as given (see there).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ibn as _ibn
from repro_torch.kernels import matmul_ln as _mln
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_chunk as _wkv


def _refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            f"backward (its output would carry no grad_fn); call it under "
            f"torch.no_grad() or torch.inference_mode(), or on CPU tensors "
            f"for the differentiable plain version")


def _check_blocks(name: str, built: dict, **given: int) -> None:
    if given != built:
        raise ValueError(f"{name}: blocks {given}; the kernel is built for "
                         f"{built} only")


def fused_ibn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              wg: Optional[torch.Tensor] = None, *, activation: str = "gelu",
              block_m: int = _ibn.BLOCKS["block_m"],
              block_f: int = _ibn.BLOCKS["block_f"]) -> torch.Tensor:
    """act(x @ w1 [* gate]) @ w2 for x of any leading shape [..., D]."""
    if not x.is_cuda:
        return ref.fused_ibn_ref(x, w1, w2, wg, activation=activation)
    _refuse_grad("fused_ibn", x, w1, w2, wg)
    _check_blocks("fused_ibn", _ibn.BLOCKS, block_m=block_m,
                  block_f=block_f)
    lead = x.shape[:-1]
    # view, not reshape: a layout that would need a copy raises here
    out = _ibn.fused_ibn(x.view(-1, x.shape[-1]), w1, w2, wg,
                         activation=activation)
    return out.reshape(*lead, w2.shape[1])


def matmul_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, *, block_m: int = 64,
              block_k: int = 64, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(x @ w + b) * gamma + beta with the statistics taken
    before the one store; x: [M, K], w: [K, N]."""
    if not x.is_cuda:
        return ref.matmul_ln_ref(x, w, b, gamma, beta, eps=eps)
    _refuse_grad("matmul_ln", x, w, b, gamma, beta)
    return _mln.matmul_ln(x, w, b, gamma, beta, block_m=block_m,
                          block_k=block_k, eps=eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    block_q: int = _fa.BLOCKS["block_q"],
                    block_k: int = _fa.BLOCKS["block_k"]
                    ) -> torch.Tensor:
    """Flash attention (whole score rows where Sk <= 128, else an online
    softmax over KV tiles); q: [B,H,Sq,D], k, v: [B,H,Sk,D].  Under grad
    mode with q, k or v requiring grad it is ``FlashAttention`` (its
    backward on the device of the tensors, as its forward); otherwise the
    served call, which writes no log-sum-exp."""
    if q.is_cuda:
        _check_blocks("flash_attention", _fa.BLOCKS, block_q=block_q,
                      block_k=block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window, scale)
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
    _refuse_grad("depthwise_conv2d", x, w, b)
    return _dw.depthwise_conv2d(x, w, b)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64):
    """Chunked WKV6 from a zero state; r, k, logw: [BH,T,K], v: [BH,T,V],
    u: [BH,K] (the per-head bonus expanded by the caller) -> (out
    [BH,T,V] in r's dtype, final state [BH,K,V] float32).

    The requested chunk is honoured verbatim (it is the searched schedule
    parameter, never shrunk to a divisor of T): the kernel takes
    C = min(chunk, T) at run time, any C, and the last chunk's rows past T
    are neither read nor written (masked by bounds, no pad copy), which
    equals the JAX kernel's zero-padded, recurrence-neutral tail.  A CPU
    tensor goes to the per-token ``ref.wkv_ref``."""
    if not r.is_cuda:
        return ref.wkv_ref(r, k, v, logw, u)
    _refuse_grad("wkv_chunked", r, k, v, logw, u)
    return _wkv.wkv_chunked(r, k, v, logw, u, chunk=chunk)
