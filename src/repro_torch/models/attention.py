"""Attention library of the LM stack: port of ``repro/models/attention.py``.

- ``flash_attention``        : causal / window masks over the full sequence
- ``flash_attention_banded`` : causal sliding-window prefill, O(S*W)
- ``decode_attention``       : one new token of GQA against a KV cache,
                               ring-buffer aware
- ``reference_attention``    : the naive oracle

All take q:[B,H,Sq,D], k/v:[B,H,Sk,D] with H already expanded to the full
query-head count (the caller repeats the KV heads), as in the JAX module.

The JAX module writes the prefill attention as a blocked online softmax in
``jnp`` (the XLA-level form of the Pallas kernel
``repro/kernels/flash_attention.py``).  Here both prefill entry points go to
``kernels.flash_attention``: the hand-written kernel on a CUDA tensor
(``ops``, the default), ``ref.attention_ref`` under ``kernels=ref.PLAIN`` or
on any CPU tensor.  The banded form is the same function with
``causal=True``: the kernel's KV loop skips every tile outside the band, so
it costs O(S*W) as the reference's band does.  The reference's ``block_q``
/ ``block_k`` are XLA blocking and are not passed on (the kernel runs its
own tile, ``kernels.flash_attention.BLOCKS``).  Decode attention is plain
tensor code in float32, as the reference computes it, and launches no
kernel.  The reference's ``custom_vjp`` is ``ops.flash_attention`` under
autograd (``kernels.flash_attention.FlashAttention``): in training its
backward is the hand-written kernel of ``csrc/flash_attention_bwd.cu`` on
the card, ``ref.attention_bwd_ref`` on the CPU, both by ``_flash_bwd``'s
formulas.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops, ref

NEG_INF = ref.NEG_INF


def reference_attention(q, k, v, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, *, kernels=ops) -> torch.Tensor:
    """Fused-softmax attention.  q,k,v: [B, H, S, D] (H = full query heads);
    the operands are made dense for the kernel (a GQA-expanded or rotated
    operand already is)."""
    return kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, scale=scale)


def flash_attention_banded(q, k, v, window: int, scale: Optional[float] = None,
                           *, kernels=ops) -> torch.Tensor:
    """Causal sliding-window attention over the KV band of each query."""
    return flash_attention(q, k, v, True, window, scale, kernels=kernels)


def decode_attention(q, k_cache, v_cache, cur_index,
                     scale: Optional[float] = None,
                     ring: bool = False) -> torch.Tensor:
    """GQA decode: q [B,Hq,1,D] against cache [B,Hkv,S,D].

    ``cur_index`` is the number of valid cache positions (a 0-d integer
    tensor).  The caller passes min(step + 1, S); for a ring buffer every
    slot is valid once it has wrapped, which that clamp already encodes, so
    ``ring`` changes nothing here (as in the reference).
    """
    del ring
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale_ = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float() * scale_
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    mask = torch.arange(S, device=q.device) < cur_index
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)
