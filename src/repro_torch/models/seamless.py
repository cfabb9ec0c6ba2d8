"""Seamless-M4T-large-v2 transformer backbone, encoder-decoder, for
inference: port of ``repro/models/seamless.py``.

A 24-layer encoder over precomputed speech-frame embeddings (the modality
frontend is a stub in the JAX package too: the batch's ``inputs_embeds``
are [B, T_src, D] frames) and a 24-layer decoder with causal
self-attention and cross-attention into the encoder's memory; sinusoidal
absolute positions, LayerNorm with biases, tanh-GELU MLPs.  Names, the
nested parameter tree and the stacked ``[L, ...]`` layouts are the JAX
module's, so that ``params.from_jax_params`` carries its tree across
unchanged; the layers are walked by a Python loop where the JAX module
scans them.

Entry points:
  param_defs(cfg)                          -> ParamDef tree
  forward(cfg, params, batch, ...)         -> decoder hidden [B,T,D], aux 0
  prefill(cfg, params, batch, decode_len=) -> (last hidden [B,D], SeamlessCache)
  decode_step(cfg, params, cache, batch)   -> (logits [B,V], SeamlessCache)

Where the work goes: every full-sequence attention -> ``kernels.
flash_attention`` (on the card, one launch each: the encoder's non-causal
self-attention, the decoder's causal self-attention over its prefix, the
cross-attention into the memory: 3 x 24 a prefill); projections and MLPs
-> plain products; decode attention, self and cross -> plain tensor code,
no kernel (as in the JAX package).

The cache is the reference's: the decoder's self K/V padded with zeros to
``decode_len`` at prefill (the source length where it is not given), the
cross K/V computed once at prefill and handed on unchanged by every
decode step (the same tensors: a donated step copies nothing of them).
At decode the reference projects the cross-attention's k and v from the
new token and discards them; the port projects q alone, which gives the
same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.params import load_cast, per_layer

Params = Dict[str, Any]


class SeamlessCache(NamedTuple):
    self_k: torch.Tensor    # [L, B, Hkv, S_dec, D]
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [L, B, Hkv, S_src, D]  (computed at prefill)
    cross_v: torch.Tensor
    step: torch.Tensor      # 0-d int32 on the device: absolute decode position


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_defs(cfg: ModelConfig) -> Params:
    enc_ld, dec_ld = (cfg.num_encoder_layers,), (cfg.num_layers,)
    enc_block: Params = {
        "ln1": L.norm_defs(cfg, enc_ld),
        "attn": L.attention_defs(cfg, enc_ld),
        "ln2": L.norm_defs(cfg, enc_ld),
        "mlp": L.mlp_defs(cfg, enc_ld),
    }
    dec_block: Params = {
        "ln1": L.norm_defs(cfg, dec_ld),
        "attn": L.attention_defs(cfg, dec_ld),
        "ln_x": L.norm_defs(cfg, dec_ld),
        "xattn": L.attention_defs(cfg, dec_ld),
        "ln2": L.norm_defs(cfg, dec_ld),
        "mlp": L.mlp_defs(cfg, dec_ld),
    }
    return {"embed": L.embedding_defs(cfg), "enc_blocks": enc_block,
            "enc_ln_f": L.norm_defs(cfg), "dec_blocks": dec_block,
            "ln_f": L.norm_defs(cfg)}


# the leaves the JAX functions cast to the compute dtype at every use
_PROJ = ("wq", "wk", "wv", "wo")
COMPUTE_DTYPE_LEAVES = (
    ["embed.embedding"]
    + [f"enc_blocks.attn.{n}" for n in _PROJ]
    + [f"dec_blocks.{a}.{n}" for a in ("attn", "xattn") for n in _PROJ]
    + [f"{b}.mlp.{n}" for b in ("enc_blocks", "dec_blocks")
       for n in ("wi", "wo", "wg")])


def load_params(cfg: ModelConfig, tree: Params, *,
                device: "torch.device | str" = "cuda") -> Params:
    """``params.load_cast`` of the encoder-decoder's tree: float32 tensors on
    ``device`` (the card by default), ``COMPUTE_DTYPE_LEAVES`` in
    ``cfg.compute_dtype``."""
    return load_cast(cfg, tree, param_defs(cfg), COMPUTE_DTYPE_LEAVES, device=device)


# ---------------------------------------------------------------------------
# Sinusoidal positions
# ---------------------------------------------------------------------------


def sinusoid(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """positions: [B,S] int -> [B,S,D] float32 sin/cos table."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freq                    # [B,S,half]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    return x + sinusoid(positions, cfg.d_model).to(x.dtype)


def _mlp(cfg: ModelConfig, bp: Params, x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp_apply(cfg, bp["mlp"], L.norm_apply(cfg, bp["ln2"], x))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: Params, src_embeds: torch.Tensor, *,
           kernels=ops, remat: bool = False) -> torch.Tensor:
    """src_embeds: [B, T_src, D] precomputed frames -> encoder memory.
    ``remat``: each block under ``layers.remat_call``."""
    B, S, _ = src_embeds.shape
    positions = torch.arange(S, device=src_embeds.device).expand(B, S)
    x = src_embeds.to(cfg.compute_dtype)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)

    def block(bp, x):
        h = L.norm_apply(cfg, bp["ln1"], x)
        x = x + L.attention_apply(cfg, bp["attn"], h, None, causal=False,
                                  kernels=kernels)
        return _mlp(cfg, bp, x)

    for bp in per_layer(params["enc_blocks"], cfg.num_encoder_layers):
        x = L.remat_call(block, bp, x, remat=remat)
    return L.norm_apply(cfg, params["enc_ln_f"], x)


# ---------------------------------------------------------------------------
# Decoder (teacher-forced)
# ---------------------------------------------------------------------------


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 memory: torch.Tensor, *, kernels=ops,
                 remat: bool = False) -> torch.Tensor:
    B, S = tokens.shape
    x = _embed(cfg, params, tokens,
               torch.arange(S, device=tokens.device).expand(B, S))

    def block(bp, x, memory):
        h = L.norm_apply(cfg, bp["ln1"], x)
        x = x + L.attention_apply(cfg, bp["attn"], h, None, causal=True,
                                  kernels=kernels)
        h = L.norm_apply(cfg, bp["ln_x"], x)
        x = x + L.attention_apply(cfg, bp["xattn"], h, None, causal=False,
                                  kernels=kernels, kv_x=memory)
        return _mlp(cfg, bp, x)

    for bp in per_layer(params["dec_blocks"], cfg.num_layers):
        x = L.remat_call(block, bp, x, memory, remat=remat)
    return L.norm_apply(cfg, params["ln_f"], x)


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, remat: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"inputs_embeds": [B,T_src,D], "tokens": [B,T_tgt]}.
    Returns (decoder hidden states [B,T_tgt,D], aux 0)."""
    memory = encode(cfg, params, batch["inputs_embeds"], kernels=kernels,
                    remat=remat)
    x = decode_train(cfg, params, batch["tokens"], memory, kernels=kernels,
                     remat=remat)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(params["embed"], hidden)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               src_len: Optional[int] = None, *,
               device: "torch.device | str" = "cuda") -> SeamlessCache:
    src = src_len or seq_len
    nl, hk, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(s):
        return torch.zeros((nl, batch, hk, s, hd), dtype=cfg.compute_dtype,
                           device=device)

    return SeamlessCache(self_k=zeros(seq_len), self_v=zeros(seq_len),
                         cross_k=zeros(src), cross_v=zeros(src),
                         step=torch.zeros((), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, decode_len: Optional[int] = None,
            **_) -> Tuple[torch.Tensor, SeamlessCache]:
    """Encode the source and compute each layer's cross-attention K/V.

    batch: {"inputs_embeds": [B,T_src,D], "tokens": [B,T0]}: T0 is the
    decoder prefix already consumed (>= 1, usually the BOS token).  The
    self K/V are padded to ``decode_len`` (the source length by default)."""
    memory = encode(cfg, params, batch["inputs_embeds"], kernels=kernels)
    tokens = batch["tokens"]
    B, T0 = tokens.shape
    S_dec = decode_len or batch["inputs_embeds"].shape[1]
    x = _embed(cfg, params, tokens,
               torch.arange(T0, device=tokens.device).expand(B, T0))
    sk, sv, xks, xvs = [], [], [], []
    for bp in per_layer(params["dec_blocks"], cfg.num_layers):
        h = L.norm_apply(cfg, bp["ln1"], x)
        q, k, v = L.qkv_project(cfg, bp["attn"], h, None)
        kr, vr = L.expand_kv(cfg, k, v)
        o = attn_lib.flash_attention(q, kr, vr, True, kernels=kernels)
        x = x + L.out_project(bp["attn"], o, x.dtype)
        # the self K/V padded out to the whole decode budget
        sk.append(F.pad(k, (0, 0, 0, S_dec - T0)))
        sv.append(F.pad(v, (0, 0, 0, S_dec - T0)))
        h = L.norm_apply(cfg, bp["ln_x"], x)
        xq, xk, xv = L.qkv_project(cfg, bp["xattn"], h, None, kv_x=memory)
        xkr, xvr = L.expand_kv(cfg, xk, xv)
        o = attn_lib.flash_attention(xq, xkr, xvr, False, kernels=kernels)
        x = x + L.out_project(bp["xattn"], o, x.dtype)
        x = _mlp(cfg, bp, x)
        xks.append(xk)
        xvs.append(xv)
    x = L.norm_apply(cfg, params["ln_f"], x)
    # step is filled on the device: a copy from the host's pageable memory
    # cannot be captured into a CUDA graph
    cache = SeamlessCache(self_k=torch.stack(sk), self_v=torch.stack(sv),
                          cross_k=torch.stack(xks), cross_v=torch.stack(xvs),
                          step=torch.full((), T0, dtype=torch.int32,
                                          device=x.device))
    return x[:, -1, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: SeamlessCache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, SeamlessCache]:
    """batch: {"tokens": [B,1]}: one decoder step against the caches.  No
    kernel: ``kernels`` is taken for the common step signature."""
    del kernels
    tokens = batch["tokens"]
    B = tokens.shape[0]
    step = cache.step
    x = _embed(cfg, params, tokens, step.reshape(1, 1).expand(B, 1))
    S_src = cache.cross_k.shape[3]
    sks, svs = [], []
    for i, bp in enumerate(per_layer(params["dec_blocks"], cfg.num_layers)):
        h = L.norm_apply(cfg, bp["ln1"], x)
        h, sk, sv = L.attention_decode_apply(cfg, bp["attn"], h, step,
                                             cache.self_k[i], cache.self_v[i],
                                             step)
        x = x + h
        h = L.norm_apply(cfg, bp["ln_x"], x)
        q = L.query_project(cfg, bp["xattn"], h, None)
        o = attn_lib.decode_attention(q, cache.cross_k[i], cache.cross_v[i], S_src)
        x = x + L.out_project(bp["xattn"], o, x.dtype)
        x = _mlp(cfg, bp, x)
        sks.append(sk)
        svs.append(sv)
    x = L.norm_apply(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, SeamlessCache(self_k=torch.stack(sks), self_v=torch.stack(svs),
                                 cross_k=cache.cross_k, cross_v=cache.cross_v,
                                 step=step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` calls each kernel (the
    encoder's self-attention, the decoder's self- and cross-attention);
    ``decode_step`` calls none."""
    return {"flash_attention": cfg.num_encoder_layers + 2 * cfg.num_layers}
