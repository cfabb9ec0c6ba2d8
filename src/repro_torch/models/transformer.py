"""Decoder-only TransformerLM, dense and VLM (M-RoPE, embedding inputs),
with sliding-window attention: port of ``repro/models/transformer.py``
for inference.

Names, the nested parameter tree and the stacked ``[L, ...]`` layouts are
the JAX module's, so that ``params.from_jax_params`` carries its tree
across unchanged; the layers are walked by a Python loop where the JAX
module scans them.

Entry points:
  param_defs(cfg)                         -> ParamDef tree
  forward(cfg, params, batch, ...)        -> final hidden states [B,S,D], aux
  prefill(cfg, params, batch, ...)        -> (last hidden [B,D], Cache)
  decode_step(cfg, params, cache, batch)  -> (logits [B,V], Cache)

Where the work goes: prefill attention -> ``kernels.flash_attention`` (one
launch a layer on the card; the banded form where the prompt is longer
than the window); projections and MLPs -> plain products; decode attention
-> plain tensor code, no kernel (as in the JAX package).

The cache is the reference's, quirks included: a prefill returns K/V of
the prompt's length (a ring of ``window`` slots where the prompt is longer),
and a decode step writes at ``step`` (``step % S`` on a ring) clamped to
S - 1, as ``lax.dynamic_update_slice_in_dim`` clamps.  Past a prompt-sized
linear cache every step overwrites its last slot; the reference's serving
path does the same (ROADMAP queue 3).  ``init_cache`` sizes a cache for a
whole generation, as the reference's tests grow one.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import from_jax_params, per_layer, tree_map

Params = Dict[str, Any]


class Cache(NamedTuple):
    """Decode-time state: KV ring/linear caches + step counter."""
    k: torch.Tensor       # [L, B, Hkv, S, D]
    v: torch.Tensor       # [L, B, Hkv, S, D]
    step: torch.Tensor    # 0-d int32 on the device: absolute decode position


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_defs(cfg: ModelConfig) -> Params:
    if cfg.moe.enabled:
        raise NotImplementedError(f"{cfg.name}: the MoE block is not ported yet "
                                  f"(ROADMAP queue 1 item 6b)")
    ld = (cfg.num_layers,)
    block: Params = {
        "ln1": L.norm_defs(cfg, ld),
        "attn": L.attention_defs(cfg, ld),
        "ln2": L.norm_defs(cfg, ld),
        "mlp": L.mlp_defs(cfg, ld),
    }
    return {"embed": L.embedding_defs(cfg), "blocks": block,
            "ln_f": L.norm_defs(cfg)}


# the leaves the JAX functions cast to the compute dtype at every use
COMPUTE_DTYPE_LEAVES = (
    ["embed.embedding"]
    + [f"blocks.attn.{n}" for n in ("wq", "wk", "wv", "wo")]
    + [f"blocks.mlp.{n}" for n in ("wi", "wo", "wg")])


def load_params(cfg: ModelConfig, tree: Params, *,
                device: "torch.device | str" = "cuda") -> Params:
    """A tree of numpy arrays (``params.init_params`` or the JAX package's
    parameters) -> tensors on ``device`` (the card by default; raises
    without one), float32, with ``COMPUTE_DTYPE_LEAVES`` cast once to
    ``cfg.compute_dtype`` (the same rounding as the reference's cast at each
    use).  Norm scales and the unembedding stay float32, as JAX reads them,
    and so does a tied embedding, which the LM head reads in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = cfg.compute_dtype
    cast = set(COMPUTE_DTYPE_LEAVES)
    if cfg.tie_embeddings:
        cast.discard("embed.embedding")

    def leaf(t, path):
        return t.to(dtype) if path in cast else t

    return tree_map(leaf, from_jax_params(tree, param_defs(cfg), device=device))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
           positions: torch.Tensor, *, kernels, ibn_chunks: int) -> torch.Tensor:
    h = L.norm_apply(cfg, bp["ln1"], x)
    x = x + L.attention_apply(cfg, bp["attn"], h, positions, kernels=kernels)
    h = L.norm_apply(cfg, bp["ln2"], x)
    return x + L.mlp_apply(cfg, bp["mlp"], h, ibn_chunks=ibn_chunks)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    if cfg.embedding_inputs and "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(cfg.compute_dtype)
    else:
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    B, S = x.shape[0], x.shape[1]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        pos = torch.arange(S, device=x.device)
        positions = (pos.expand(3, B, S) if cfg.rope == "mrope"
                     else pos.expand(B, S))
    return x, positions


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, ibn_chunks: int = 0, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D] post-ln_f, aux loss 0: no MoE)."""
    x, positions = _embed_inputs(cfg, params, batch)
    for bp in per_layer(params["blocks"], cfg.num_layers):
        x = _block(cfg, bp, x, positions, kernels=kernels, ibn_chunks=ibn_chunks)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(params["embed"], hidden)


# ---------------------------------------------------------------------------
# Prefill: forward + build KV cache
# ---------------------------------------------------------------------------


def _to_ring(arr: torch.Tensor, window: int) -> torch.Tensor:
    """[B,H,S,D] -> ring cache [B,H,W,D] holding the last ``window``
    positions at slots (pos % window)."""
    S = arr.shape[2]
    slots = torch.arange(S - window, S, device=arr.device) % window
    out = torch.zeros(arr.shape[:2] + (window,) + arr.shape[3:], dtype=arr.dtype,
                      device=arr.device)
    return out.index_copy(2, slots, arr[:, :, S - window:])


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.window, seq_len) if cfg.window else seq_len


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, **_) -> Tuple[torch.Tensor, Cache]:
    """Run the full prompt, return (last hidden [B,D], cache).  One
    ``kernels.flash_attention`` a layer: the banded form where the prompt
    is longer than the window, whose K/V then go to a ring of ``window``."""
    x, positions = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    W = cache_len(cfg, S)
    banded = cfg.window is not None and cfg.window < S
    ks, vs = [], []
    for bp in per_layer(params["blocks"], cfg.num_layers):
        h = L.norm_apply(cfg, bp["ln1"], x)
        q, k, v = L.qkv_project(cfg, bp["attn"], h, positions)
        kr, vr = L.expand_kv(cfg, k, v)
        if banded:
            o = L.attn_lib.flash_attention_banded(q, kr, vr, cfg.window,
                                                  kernels=kernels)
        else:
            o = L.attn_lib.flash_attention(q, kr, vr, cfg.causal, cfg.window,
                                           kernels=kernels)
        x = x + L.out_project(bp["attn"], o, x.dtype)
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
        if banded:
            k, v = _to_ring(k, W), _to_ring(v, W)
        ks.append(k)
        vs.append(v)
    x = L.norm_apply(cfg, params["ln_f"], x)
    # step is filled on the device: a copy from the host's pageable memory
    # cannot be captured into a CUDA graph
    cache = Cache(k=torch.stack(ks), v=torch.stack(vs),
                  step=torch.full((), S, dtype=torch.int32, device=x.device))
    return x[:, -1, :], cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: "torch.device | str" = "cuda") -> Cache:
    W = cache_len(cfg, seq_len)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, W, cfg.head_dim)
    return Cache(k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                 v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                 step=torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Decode: one token, cache update
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, Cache]:
    """batch: {"tokens": [B,1]} (or {"inputs_embeds": [B,1,D]}).
    Returns (logits [B,V] for the new token, updated cache).  No kernel:
    ``kernels`` is taken for the common step signature."""
    del kernels
    if cfg.embedding_inputs and "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(cfg.compute_dtype)
    else:
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    step = cache.step
    ks, vs = [], []
    for i, bp in enumerate(per_layer(params["blocks"], cfg.num_layers)):
        h = L.norm_apply(cfg, bp["ln1"], x)
        h, ck, cv = L.attention_decode_apply(cfg, bp["attn"], h, step,
                                             cache.k[i], cache.v[i], step,
                                             window=cfg.window)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
        ks.append(ck)
        vs.append(cv)
    x = L.norm_apply(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, Cache(k=torch.stack(ks), v=torch.stack(vs), step=step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` calls each kernel;
    ``decode_step`` calls none."""
    return {"flash_attention": cfg.num_layers}
