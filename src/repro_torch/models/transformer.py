"""Decoder-only TransformerLM, dense, VLM (M-RoPE, embedding inputs) and
MoE, with sliding-window attention: port of ``repro/models/transformer.py``.

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
than the window); projections, MLPs and the MoE block's router, experts
and shared experts -> plain products (``layers.moe_apply_auto``); decode
attention -> plain tensor code, no kernel (as in the JAX package).

The cache is the reference's, quirks included: a prefill returns K/V of
the prompt's length (a ring of ``window`` slots where the prompt is longer),
and a decode step writes at ``step`` (``step % S`` on a ring) clamped to
S - 1, as ``lax.dynamic_update_slice_in_dim`` clamps.  Past a prompt-sized
linear cache every step overwrites its last slot; the reference's serving
path does the same (ROADMAP queue 3).  ``init_cache`` sizes a cache for a
whole generation, as the reference's tests grow one.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard
from repro_torch.models import layers as L
from repro_torch.models.params import draw_cast, load_cast, per_layer

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
    ld = (cfg.num_layers,)
    block: Params = {
        "ln1": L.norm_defs(cfg, ld),
        "attn": L.attention_defs(cfg, ld),
        "ln2": L.norm_defs(cfg, ld),
    }
    if cfg.moe.enabled:
        block["moe"] = L.moe_defs(cfg, ld)
    else:
        block["mlp"] = L.mlp_defs(cfg, ld)
    return {"embed": L.embedding_defs(cfg), "blocks": block,
            "ln_f": L.norm_defs(cfg)}


# the leaves the JAX functions cast to the compute dtype at every use (a
# model holds the MLP's or the MoE block's, as its config says)
COMPUTE_DTYPE_LEAVES = (
    ["embed.embedding"]
    + [f"blocks.attn.{n}" for n in ("wq", "wk", "wv", "wo")]
    + [f"blocks.mlp.{n}" for n in ("wi", "wo", "wg")]
    + [f"blocks.moe.{n}" for n in ("router", "wi", "wg", "wo", "shared_gate")]
    + [f"blocks.moe.shared.{n}" for n in ("wi", "wg", "wo")])


def load_params(cfg: ModelConfig, tree: Params, *,
                device: "torch.device | str" = "cuda") -> Params:
    """``params.load_cast`` of the transformer's tree: float32 tensors on
    ``device`` (the card by default), ``COMPUTE_DTYPE_LEAVES`` in
    ``cfg.compute_dtype``."""
    return load_cast(cfg, tree, param_defs(cfg), COMPUTE_DTYPE_LEAVES, device=device)


def init_on_device(cfg: ModelConfig, seed: int, *,
                   device: "torch.device | str" = "cuda",
                   layers: Optional[int] = None) -> Params:
    """``params.draw_cast`` of the transformer's tree: its weights drawn on
    ``device`` from ``seed``, ``COMPUTE_DTYPE_LEAVES`` straight in
    ``cfg.compute_dtype``; ``load_params`` takes the tree as it is.
    ``layers=n``: the first n layer slices only, the same numbers."""
    return draw_cast(cfg, seed, param_defs(cfg), COMPUTE_DTYPE_LEAVES, device=device,
                     layers=layers)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, bp: Params, h: torch.Tensor, *, ibn_chunks: int = 0,
         moe_capacity: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's feed-forward half: (out, MoE aux loss, 0 for an MLP)."""
    if cfg.moe.enabled:
        return L.moe_apply_auto(cfg, bp["moe"], h, capacity_factor=moe_capacity)
    return (L.mlp_apply(cfg, bp["mlp"], h, ibn_chunks=ibn_chunks),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
           positions: torch.Tensor, *, kernels, ibn_chunks: int,
           moe_capacity: float) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.norm_apply(cfg, bp["ln1"], x)
    x = x + L.attention_apply(cfg, bp["attn"], h, positions, kernels=kernels)
    h = L.norm_apply(cfg, bp["ln2"], x)
    h, aux = _ffn(cfg, bp, h, ibn_chunks=ibn_chunks, moe_capacity=moe_capacity)
    return x + h, aux


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    if cfg.embedding_inputs and "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(cfg.compute_dtype)
    else:
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    B, S = x.shape[0], x.shape[1]
    if "positions" in batch:
        positions = batch["positions"]
    else:                   # the rank's positions under 'cp'
        pos = actshard.positions(S, x.device)
        positions = (pos.expand(3, B, S) if cfg.rope == "mrope"
                     else pos.expand(B, S))
    return x, positions


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, remat: bool = False, ibn_chunks: int = 0,
            moe_capacity: float = 1.25, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D] post-ln_f, MoE aux loss: the
    mean over the layers, 0 without MoE).  ``remat``: each block under
    ``layers.remat_call`` (training).  Under the sharded train step each
    block gathers its leaves inside the remat'd function
    (``actshard.gathered``), the final norm at its use."""
    x, positions = _embed_inputs(cfg, params, batch)
    x = actshard.batch_sharded(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(bp, x):
        x = actshard.batch_sharded(x)
        return _block(cfg, actshard.gathered(bp, "blocks"), x, positions,
                      kernels=kernels, ibn_chunks=ibn_chunks,
                      moe_capacity=moe_capacity)

    for bp in per_layer(params["blocks"], cfg.num_layers):
        x, aux_i = L.remat_call(block, bp, x, remat=remat)
        aux = aux + aux_i
    x = actshard.batch_sharded(x)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    return x, aux / cfg.num_layers


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return actshard.logits_sharded(L.lm_logits(params["embed"], hidden))


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
    ``kernels.flash_attention`` a layer (``layers.attention_apply``): the
    banded form where the prompt is longer than the window, whose K/V then
    go to a ring of ``window``.  Under a serving layout each layer gathers
    its leaves at use and runs the kernel on the rank's heads, and the
    rank keeps its block of the cache (``actshard.to_cache``: its slots of
    every KV head where 'model' splits them, after the ring).  Under 'cp'
    the rank runs its S / n positions: the cache, linear or a ring, is
    built from the whole sequence's K / V that the attention gathered
    (positions S - W ... S - 1 from whichever ranks hold them, no further
    move) and cut to the rank's slots, and the last hidden state is the
    last rank's (``actshard.seq_last``)."""
    x, positions = _embed_inputs(cfg, params, batch)
    S = actshard.seq_len(x.shape[1])
    W = cache_len(cfg, S)
    banded = cfg.window is not None and cfg.window < S
    kv_dim = 1 if L.kv_heads_split() else None
    ks, vs = [], []
    for bp in per_layer(params["blocks"], cfg.num_layers):
        bp = actshard.gathered(bp, "blocks")
        x = actshard.batch_sharded(x)
        h = L.norm_apply(cfg, bp["ln1"], x)
        o, k, v = L.attention_apply(cfg, bp["attn"], h, positions, kernels=kernels,
                                    return_kv=True)
        x = x + o
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + _ffn(cfg, bp, h)[0]
        if banded:
            k, v = _to_ring(k, W), _to_ring(v, W)
        ks.append(actshard.to_cache("k", k, kv_dim))
        vs.append(actshard.to_cache("v", v, kv_dim))
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    # step is filled on the device: a copy from the host's pageable memory
    # cannot be captured into a CUDA graph
    cache = Cache(k=torch.stack(ks), v=torch.stack(vs),
                  step=torch.full((), S, dtype=torch.int32, device=x.device))
    return actshard.seq_last(x[:, -1, :]), cache


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
    ``kernels`` is taken for the common step signature.  Under a serving
    layout each layer gathers its leaves at use, the attention follows the
    cache's split (``layers.attention_decode_apply``) and the logits are
    the rank's vocabulary slice (``layers.lm_logits``)."""
    del kernels
    if cfg.embedding_inputs and "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(cfg.compute_dtype)
    else:
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    step = cache.step
    ks, vs = [], []
    for i, bp in enumerate(per_layer(params["blocks"], cfg.num_layers)):
        bp = actshard.gathered(bp, "blocks")
        h = L.norm_apply(cfg, bp["ln1"], x)
        h, ck, cv = L.attention_decode_apply(cfg, bp["attn"], h, step,
                                             cache.k[i], cache.v[i], step,
                                             window=cfg.window)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + _ffn(cfg, bp, h)[0]
        ks.append(ck)
        vs.append(cv)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, Cache(k=torch.stack(ks), v=torch.stack(vs), step=step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` calls each kernel;
    ``decode_step`` calls none."""
    return {"flash_attention": cfg.num_layers}
