"""Shared layers of the LM stack: norms, activations, embedding, LM head.

Port of the part of ``repro/models/layers.py`` that RWKV-6 uses, with the
JAX names, parameter layouts and rounding points: a norm computes in
float32 and returns the input's dtype, ``lm_logits`` is a float32 product
with the unembedding.  The MLP, MoE, RoPE and attention halves are ROADMAP
queue 1 item 6.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

Params = Dict[str, Any]


def norm_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef(layers_dim + (d,), "ones")}
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef(layers_dim + (d,), "ones"),
            "bias": ParamDef(layers_dim + (d,), "zeros"),
        }
    if cfg.norm == "nonparam_ln":  # OLMo: LN without learnable params
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.square(xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * params["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def embedding_defs(cfg: ModelConfig) -> Params:
    v = cfg.padded_vocab
    defs: Params = {"embedding": ParamDef((v, cfg.d_model), "embed", scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, v))
    return defs


def embed_tokens(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens: [B, S] integer -> [B, S, D] in ``dtype``."""
    w = params["embedding"]
    rows = torch.index_select(w, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, w.shape[1]).to(dtype)


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B, S, padded vocab], a float32 product (exact float32
    on the card as long as TF32 matmul is off, which the models set)."""
    w = params["unembed"] if "unembed" in params else params["embedding"].T
    return torch.matmul(x.float(), w.float())
