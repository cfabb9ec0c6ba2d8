"""Attention library of the LM stack: port of ``repro/models/attention.py``.

- ``flash_attention``        : causal / window masks over the full sequence
- ``flash_attention_banded`` : causal sliding-window prefill, O(S*W)
- ``decode_attention``       : one new token of GQA against a KV cache,
                               ring-buffer aware
- ``decode_attention_partial`` / ``merge_partials``: the same over blocks
                               of the cache's slots (flash-decoding's
                               split-S), each block's (o, m, l) merged by
                               their log-sum-exp, over the ranks of a mesh
                               axis where given
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
kernel; so are its partial form and the merge, which the serving steps run
where 'model' splits the cache's slots (the reference's GSPMD splits the
same softmax over them).  The reference's ``custom_vjp`` is ``ops.flash_attention`` under
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
                    scale: Optional[float] = None, *, kernels=ops,
                    q_offset: int = 0) -> torch.Tensor:
    """Fused-softmax attention.  q,k,v: [B, H, S, D] (H = full query heads);
    the operands are made dense for the kernel (a GQA-expanded or rotated
    operand already is).  ``q_offset``: the position of query row 0 less
    that of key row 0 (passed on only where it is not 0)."""
    kw = {"q_offset": q_offset} if q_offset else {}
    return kernels.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, scale=scale, **kw)


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


def decode_attention_partial(q, k_block, v_block, slots, cur_index,
                             scale: Optional[float] = None):
    """``decode_attention`` over a block of the cache's slots: q [B,Hq,1,D]
    against k/v_block [B,Hkv,Sb,D], whose slot j is the cache's slot
    ``slots[j]`` (its global index, [Sb] integer), masked against
    ``cur_index`` as the whole cache is.  Returns the block's partial
    softmax, float32: (o [B,Hq,1,D], the probabilities' unnormalised sum
    with v; m [B,Hq,1,1], the block's largest logit; l [B,Hq,1,1], the sum
    of e^(logit - m)).  A block whose slots are all masked gives m =
    ``NEG_INF``, l = 0 and o = 0: it adds nothing to ``merge_partials``."""
    B, Hq, _, D = q.shape
    Hkv, Sb = k_block.shape[1], k_block.shape[2]
    G = Hq // Hkv
    scale_ = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float() * scale_
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_block.float())
    mask = slots < cur_index
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_block.float())
    return (o.reshape(B, Hq, 1, D), m.reshape(B, Hq, 1, 1), l.reshape(B, Hq, 1, 1))


def merge_partials(partials, mesh=None, axis: str = "model") -> torch.Tensor:
    """The attention output [B,Hq,1,D] (float32) of the blocks whose
    ``decode_attention_partial``s are ``partials`` (a list held here), and,
    with a ``mesh``, of every rank's blocks over ``axis``: m* the largest m
    (``collectives.pmax`` over the axis), then the sums of l e^(m - m*)
    and of o e^(m - m*) (one ``collectives.psum`` of both), o* / l*.  It
    is the softmax over the union of the blocks' slots, up to the order of
    its sums."""
    from repro_torch.runtime import collectives as C
    m_star = partials[0][1]
    for _, m, _ in partials[1:]:
        m_star = torch.maximum(m_star, m)
    if mesh is not None:
        m_star = C.pmax(m_star, mesh, axis)
    acc = None
    for o, m, l in partials:
        w = torch.exp(m - m_star)
        part = torch.cat([o * w, l * w], -1)
        acc = part if acc is None else acc + part
    if mesh is not None:
        acc = C.psum(acc, mesh, axis)
    return acc[..., :-1] / acc[..., -1:]
