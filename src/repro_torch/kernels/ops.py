"""Public entry points of the kernels, with the signatures of the JAX
package's ``repro.kernels.ops``.

Routing is by the tensor's device and by nothing else: a CPU tensor goes
to the plain version in ``ref``, whatever ``block_*`` it is given; a CUDA
tensor launches the hand-written kernel, or raises if it cannot be built
or launched; a ``meta`` tensor gets empty outputs of the kernel's shapes
and dtypes, nothing launched and no plain version run (the dry-run's
trace, ``launch.dryrun``).  No flag, no fallback.

Under a ``core.opcount.OpCounter`` each call adds its function's work by
formula (``opcount.kernel``: the FLOPs, each operand read once and each
output written once), and no aten op inside it counts, so the three
routes give one count.

``adamw_update`` is the optimizer's update of one leaf in place, no
kernel of the JAX package but the fusion its launcher's jit makes of the
reference's update (``kernels.adamw``); its plain version is
``ref.adamw_ref``, under ``ref.PLAIN`` too.  It writes its leaf in place
behind autograd's back, so on a CUDA tensor it refuses, as the three
kernels below do, an input that requires grad under grad mode.

Gradients: ``flash_attention`` goes through ``FlashAttention`` where grad
mode is on and q, k or v requires grad, and ``wkv_chunked`` through
``WKVChunked`` where r, k, v, logw or u does; the backward of each is a
hand-written kernel too on a CUDA tensor, and its plain version on a CPU
one.  The other three kernels have no backward yet: on a CUDA tensor
under grad mode with any input (weights included) that requires grad,
they raise ``RuntimeError`` before anything launches, where a fresh
output with no ``grad_fn`` would drop the gradient without a word.  On
CPU tensors their plain versions stay differentiable.

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

from repro_torch.core import opcount
from repro_torch.kernels import adamw as _adamw
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
    lead = x.shape[:-1]
    M, (D, Fd), Do = x.numel() // x.shape[-1], w1.shape, w2.shape[1]
    with opcount.kernel(
            "fused_ibn", flops=2 * M * (D * Fd * (2 if wg is not None else 1) + Fd * Do),
            bytes_accessed=opcount.nbytes(x, w1, w2, wg) + M * Do * x.element_size(),
            transcendentals=M * Fd if activation in ("gelu", "silu") else 0,
            reads=(x, w1, w2, wg)):
        if x.is_cpu:
            return ref.fused_ibn_ref(x, w1, w2, wg, activation=activation)
        _refuse_grad("fused_ibn", x, w1, w2, wg)
        _check_blocks("fused_ibn", _ibn.BLOCKS, block_m=block_m,
                      block_f=block_f)
        if x.is_meta:
            return x.new_empty((*lead, Do))
        # view, not reshape: a layout that would need a copy raises here
        out = _ibn.fused_ibn(x.view(-1, x.shape[-1]), w1, w2, wg,
                             activation=activation)
        return out.reshape(*lead, Do)


def matmul_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, *, block_m: int = 64,
              block_k: int = 64, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(x @ w + b) * gamma + beta with the statistics taken
    before the one store; x: [M, K], w: [K, N]."""
    (M, K), N = x.shape, w.shape[1]
    with opcount.kernel("matmul_ln", flops=2 * M * N * K,
                        bytes_accessed=opcount.nbytes(x, w, b, gamma, beta)
                        + M * N * x.element_size(), transcendentals=M,
                        reads=(x, w, b, gamma, beta)):
        if x.is_cpu:
            return ref.matmul_ln_ref(x, w, b, gamma, beta, eps=eps)
        _refuse_grad("matmul_ln", x, w, b, gamma, beta)
        if x.is_meta:
            return x.new_empty((M, N))
        return _mln.matmul_ln(x, w, b, gamma, beta, block_m=block_m,
                              block_k=block_k, eps=eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    block_q: int = _fa.BLOCKS["block_q"],
                    block_k: int = _fa.BLOCKS["block_k"],
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention (whole score rows where Sk <= 128, else an online
    softmax over KV tiles); q: [B,H,Sq,D], k, v: [B,H,Sk,D]; ``q_offset``
    the position of query row 0 less that of key row 0, which the masks
    read (a sequence shard's queries against the keys before them).  Under grad
    mode with q, k or v requiring grad it is ``FlashAttention`` (its
    backward on the device of the tensors, as its forward); otherwise the
    served call, which writes no log-sum-exp."""
    if q.is_cuda:
        _check_blocks("flash_attention", _fa.BLOCKS, block_q=block_q,
                      block_k=block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
    with _fa.counted(q, k, v, causal=causal, window=window, q_offset=q_offset):
        if q.is_cpu:
            return ref.attention_ref(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
        if q.is_meta:
            return torch.empty_like(q)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     block_c: int = 128) -> torch.Tensor:
    """Channels-last SAME depthwise conv; x: [B,H,W,C], w: [fy,fx,C]."""
    with opcount.kernel("depthwise_conv2d", flops=2 * x.numel() * w.shape[0] * w.shape[1],
                        bytes_accessed=2 * opcount.nbytes(x) + opcount.nbytes(w, b),
                        reads=(x, w, b)):
        if x.is_cpu:
            return ref.depthwise_conv2d_ref(x, w, b)
        _refuse_grad("depthwise_conv2d", x, w, b)
        if x.is_meta:
            return torch.empty_like(x)
        return _dw.depthwise_conv2d(x, w, b)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                state: Optional[torch.Tensor] = None):
    """Chunked WKV6 from ``state`` (float32 [BH,K,V]; None is the zero
    state); r, k, logw: [BH,T,K], v: [BH,T,V], u: [BH,K] (the per-head
    bonus expanded by the caller) -> (out [BH,T,V] in r's dtype, final
    state [BH,K,V] float32).

    The requested chunk is honoured verbatim (it is the searched schedule
    parameter, never shrunk to a divisor of T): the kernel takes
    C = min(chunk, T) at run time, any C, and the last chunk's rows past T
    are neither read nor written (masked by bounds, no pad copy), which
    equals the JAX kernel's zero-padded, recurrence-neutral tail.  A CPU
    tensor goes to the per-token ``ref.wkv_ref``.  Under grad mode with r,
    k, v, logw, u or the state requiring grad it is ``WKVChunked`` (its
    backward on the device of the tensors, as its forward, dS0 among its
    gradients); otherwise the served call, which keeps nothing for a
    backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, logw, u, state)):
        return _wkv.WKVChunked.apply(r, k, v, logw, u, state, chunk)
    with _wkv.counted(r, k, v, logw, u, state, chunk):
        if r.is_cpu:
            return ref.wkv_ref(r, k, v, logw, u, state)
        if r.is_meta:
            return _wkv.meta_outputs(r, v)
        return _wkv.wkv_chunked(r, k, v, logw, u, chunk=chunk, state=state)


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                 lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                 scale: Optional[torch.Tensor] = None, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """One AdamW step of the float32 leaf ``p`` with gradient ``g`` and
    moments ``m`` and ``v``, written into ``p``, ``m`` and ``v``: the
    reference's per-leaf ``upd`` on ``g * scale`` (the clip's factor;
    None: no clip).  ``lr``, ``bc1`` = 1 - b1^count and ``bc2`` are 0-d
    float32 tensors on the leaf's device, read by the kernel from there.
    Counted by ``opcount.adamw_counts`` on every route."""
    with opcount.kernel("adamw", **opcount.adamw_counts(p, g, m, v, lr, bc1, bc2, scale),
                        reads=(p, g, m, v, lr, bc1, bc2, scale)):
        kw = dict(lr=lr, bc1=bc1, bc2=bc2, scale=scale, b1=b1, b2=b2, eps=eps,
                  weight_decay=weight_decay)
        if p.is_cpu:
            return ref.adamw_ref(p, g, m, v, **kw)
        _refuse_grad("adamw_update", p, g, m, v)
        if p.is_meta:
            return None
        return _adamw.adamw_update(p, g, m, v, **kw)
