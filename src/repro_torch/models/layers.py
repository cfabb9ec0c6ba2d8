"""Shared layers of the LM stack: norms, activations, the MLP (plain and
chunked), the MoE block, RoPE / M-RoPE, the GQA attention layer (self and
cross), embedding, LM head.

Port of ``repro/models/layers.py``, with the JAX names, parameter layouts
and rounding points: a norm computes in float32 and returns the input's
dtype, RoPE rotates in float32, the projections, the MLP and the experts
are products in the compute dtype (``torch.matmul`` / ``torch.bmm``, as
they are XLA's in the JAX package), the router's logits are cast to
float32 after their product, ``lm_logits`` is a float32 product with the
unembedding.  The reference's ``actshard`` anchors are left out:
one device (the distributed runtime is item 8).  Prefill attention goes
through ``kernels.flash_attention`` (``models.attention``); decode
attention is plain tensor code, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
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


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """QK-norm: RMS over the head dim."""
    xf = x.float()
    var = torch.square(xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def remat_call(fn, *args, remat: bool = False):
    """``fn(*args)``; where ``remat`` and grad mode is on, under
    ``torch.utils.checkpoint`` (non-reentrant): the block's activations are
    dropped after its forward and recomputed in the backward, as the
    reference's ``jax.checkpoint`` of each scanned block.  The values are
    the same either way."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# MLP (inverted bottleneck) — plain and chunked (C3) paths
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = (),
             d_model: Optional[int] = None,
             d_ff: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    defs: Params = {"wi": ParamDef(layers_dim + (d, f)),
                    "wo": ParamDef(layers_dim + (f, d))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef(layers_dim + (d, f))
    return defs


def mlp_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
              ibn_chunks: int = 0) -> torch.Tensor:
    """FFN.  ``ibn_chunks > 1`` is the depth-first inverted-bottleneck
    schedule (contribution C3): the d_ff intermediate is produced and
    consumed one tile at a time, the output summed tile by tile in the
    compute dtype as the reference's unrolled scan sums it.  Plain products
    on every device (no LM MLP goes through ``ops.fused_ibn`` until it has
    an LM-width tiling, ROADMAP queue 2 b)."""
    dtype = x.dtype
    wi, wo = params["wi"].to(dtype), params["wo"].to(dtype)
    wg = params.get("wg")
    gated = wg is not None
    if gated:
        wg = wg.to(dtype)
    if ibn_chunks <= 1:
        h = x @ wi
        h = activation(cfg.mlp, x @ wg) * h if gated else activation(cfg.mlp, h)
        return h @ wo
    f = wi.shape[-1]
    assert f % ibn_chunks == 0, (f, ibn_chunks)
    tile = f // ibn_chunks
    out = torch.zeros(x.shape[:-1] + (wo.shape[-1],), dtype=dtype,
                      device=x.device)
    for c in range(ibn_chunks):
        cols = slice(c * tile, (c + 1) * tile)
        if gated:
            t = activation(cfg.mlp, x @ wg[:, cols]) * (x @ wi[:, cols])
        else:
            t = activation(cfg.mlp, x @ wi[:, cols])
        out = out + t @ wo[cols]
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice, capacity-bounded)
# ---------------------------------------------------------------------------


def moe_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts_padded, m.d_ff_expert
    defs: Params = {"router": ParamDef(layers_dim + (d, e)),
                    "wi": ParamDef(layers_dim + (e, d, f)),
                    "wo": ParamDef(layers_dim + (e, f, d))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef(layers_dim + (e, d, f))
    if m.num_shared_experts:
        defs["shared"] = mlp_defs(cfg, layers_dim, d_model=d, d_ff=m.d_ff_shared)
        defs["shared_gate"] = ParamDef(layers_dim + (d, 1))
    return defs


def moe_apply_auto(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block as the models call it.  The reference picks its
    shard-local form under a production mesh; the port has no mesh until
    the distributed runtime (ROADMAP queue 1 item 8), so this is always
    the plain ``moe_apply``."""
    return moe_apply(cfg, params, x, capacity_factor=capacity_factor)


def moe_route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Router of ``moe_apply``: xt [N, d] -> (probs [N, E] float32, gate
    values [N, k] float32, expert indices [N, k]).  Padded experts are
    masked to ``NEG_INF`` before the softmax.  The top k come from a stable
    descending sort, so that equal probabilities go to the lower expert
    index first, as ``lax.top_k`` orders them (``torch.topk`` promises no
    order among equals)."""
    m = cfg.moe
    logits = (xt @ router.to(xt.dtype)).float()
    if m.num_experts_padded > m.num_experts:
        pad = torch.arange(m.num_experts_padded, device=xt.device) >= m.num_experts
        logits = logits.masked_fill(pad[None, :], attn_lib.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :m.top_k], idx[:, :m.top_k]
    if m.norm_topk_prob:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def moe_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity-bounded sort-free dispatch.

    x: [..., N, d] flattened internally to [N, d].  Returns (out, aux_loss).
    Claims on an expert are taken token-major, choice-minor; a claim past
    the expert's ``capacity`` is dropped (its row of the dispatch buffer
    is a sentinel cut off after the scatter, as ``mode="drop"`` discards
    it, and its gathered output is zero).  Every step stays on the device
    and the shapes depend on N alone, so the block can be captured."""
    m = cfg.moe
    orig_shape, d = x.shape, x.shape[-1]
    xt = x.reshape(-1, d)
    n, e_pad, e_real, k = xt.shape[0], m.num_experts_padded, m.num_experts, m.top_k
    dtype, dev = x.dtype, x.device

    probs, gate_vals, expert_idx = moe_route(cfg, params["router"], xt)

    # load-balancing aux loss (Switch-style), over real experts only
    me = probs[:, :e_real].mean(0)
    ce = torch.zeros(e_pad, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((n * k,), 1.0 / (n * k), dtype=torch.float32, device=dev))
    aux_loss = e_real * torch.sum(me * ce[:e_real])

    # capacity-bounded dispatch: slot = expert * C + position_in_expert
    capacity = int(max(1, (k * n * capacity_factor) // e_pad))
    flat_expert = expert_idx.reshape(-1)                          # [N*k]
    # the reference's cumsum over the [N*k, E] one-hot, taken over its
    # transpose [E, N*k]: the same integers, but a scan along the inner
    # dimension, which the card runs in parallel (along the outer one,
    # PyTorch's scan took 1.5 ms at N*k = 8192 on the H100)
    onehot_t = flat_expert[None, :] == torch.arange(e_pad, device=dev)[:, None]
    pos_in_expert = onehot_t.cumsum(1).gather(0, flat_expert[None, :])[0] - 1
    keep = pos_in_expert < capacity
    sentinel = e_pad * capacity
    slot = torch.where(keep, flat_expert * capacity + pos_in_expert, sentinel)
    token_idx = torch.arange(n, device=dev).repeat_interleave(k)
    buf = torch.zeros(sentinel + 1, d, dtype=dtype, device=dev).index_copy_(
        0, slot, xt[token_idx])[:sentinel].view(e_pad, capacity, d)

    h = torch.bmm(buf, params["wi"].to(dtype))
    if "wg" in params:
        h = activation(cfg.mlp, torch.bmm(buf, params["wg"].to(dtype))) * h
    else:
        h = activation(cfg.mlp, h)
    expert_out = torch.bmm(h, params["wo"].to(dtype)).reshape(sentinel, d)

    gathered = expert_out.index_select(0, slot.clamp(max=sentinel - 1))
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=dtype,
                                                                device=dev))
    weighted = gathered * gate_vals.reshape(-1, 1).to(dtype)
    out = weighted.reshape(n, k, d).sum(1)

    if m.num_shared_experts:
        shared = mlp_apply(cfg, params["shared"], xt)
        sg = torch.sigmoid((xt @ params["shared_gate"].to(dtype)).float())
        out = out + shared * sg.to(dtype)
    return out.reshape(orig_shape), aux_loss


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: "torch.device | str" = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B,H,S,D], positions: [B,S] (int). GPT-NeoX half rotation."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                # [D/2]
    angles = positions[:, None, :, None].float() * freqs           # [B,1,S,D/2]
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): positions [3,B,S] (t/h/w streams), the head_dim/2
    frequency slots are partitioned into ``sections``, each rotated by its
    own position stream.  The slot -> stream map is built on the device (no
    copy from the host, so the step stays capturable)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    slot = torch.arange(half, device=x.device)
    sec_id = torch.zeros(half, dtype=torch.long, device=x.device)
    edge = 0
    for n in sections[:-1]:
        edge += n
        sec_id += (slot >= edge).long()
    pos_sel = positions[sec_id]                                    # [half,B,S]
    angles = pos_sel.permute(1, 2, 0).float() * freqs              # [B,S,half]
    return _rotate(x, torch.cos(angles[:, None]), torch.sin(angles[:, None]))


def positional_rotate(cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


# ---------------------------------------------------------------------------
# GQA attention layer (projections + flash / decode core)
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs: Params = {
        "wq": ParamDef(layers_dim + (d, h, hd)),
        "wk": ParamDef(layers_dim + (d, hk, hd)),
        "wv": ParamDef(layers_dim + (d, hk, hd)),
        "wo": ParamDef(layers_dim + (h, hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(layers_dim + (hd,), "ones")
        defs["k_norm"] = ParamDef(layers_dim + (hd,), "ones")
    return defs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bhse") as one product: [B,S,d] @ [d,h*e]."""
    B, S, _ = x.shape
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).view(B, S, h, e).transpose(1, 2)


def query_project(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  positions: Optional[torch.Tensor]) -> torch.Tensor:
    """The q of ``qkv_project`` alone: [B,H,S,D]."""
    q = _heads(x, params["wq"])
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
    if positions is not None and cfg.rope != "none":
        q = positional_rotate(cfg, q, positions)
    return q


def qkv_project(cfg: ModelConfig, params: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor],
                kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None):
    """Returns q:[B,H,S,D], k,v:[B,Hkv,Skv,D] (rope applied, qk-norm
    applied); k and v are made from ``kv_x`` (cross-attention) where given."""
    kv_src = x if kv_x is None else kv_x
    kv_pos = positions if kv_positions is None else kv_positions
    q = query_project(cfg, params, x, positions)
    k, v = _heads(kv_src, params["wk"]), _heads(kv_src, params["wv"])
    if cfg.qk_norm:
        k = rms_head_norm(k, params["k_norm"])
    if positions is not None and cfg.rope != "none":
        k = positional_rotate(cfg, k, kv_pos)
    return q, k, v


def out_project(params: Params, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum("bhse,hed->bsd"): [B,H,S,D] -> [B,S,d]."""
    B, H, S, e = o.shape
    w = params["wo"].to(dtype)
    return o.transpose(1, 2).reshape(B, S, H * e) @ w.reshape(H * e, w.shape[-1])


def expand_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """GQA: each KV head repeated for its ``q_per_kv`` query heads, so that
    query head h reads KV head h // G (``jnp.repeat(k, G, axis=1)``)."""
    G = cfg.q_per_kv
    if G > 1:
        return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return k, v


def attention_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    causal: Optional[bool] = None,
                    window: Optional[int] = None, kernels=ops,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill); cross-attention into
    ``kv_x`` where given."""
    causal_ = cfg.causal if causal is None else causal
    window_ = cfg.window if window is None else window
    q, k, v = qkv_project(cfg, params, x, positions, kv_x=kv_x,
                          kv_positions=kv_positions)
    k, v = expand_kv(cfg, k, v)
    o = attn_lib.flash_attention(q, k, v, causal_, window_, kernels=kernels)
    return out_project(params, o, x.dtype)


def attention_decode_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
                           position: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_index: torch.Tensor,
                           window: Optional[int] = None):
    """Single-token decode.  x: [B,1,d].  cache_k/v: [B,Hkv,S,D].

    Returns (out [B,1,d], new_cache_k, new_cache_v).  ``cache_index`` is the
    absolute decode step, a 0-d integer tensor on the device (as are the
    write index, ``valid`` and the RoPE position, so that the step can be
    captured); ring addressing is used iff window is not None.  The write
    index is clamped to S - 1, as ``lax.dynamic_update_slice_in_dim``
    clamps it: past a linear cache of the prompt's length every step
    overwrites its last slot, as the reference's does.
    """
    B = x.shape[0]
    S = cache_k.shape[2]
    if cfg.rope == "mrope":
        # text-token M-RoPE: all three streams advance with the step
        positions = position.reshape(1, 1, 1).expand(3, B, 1)
    else:
        positions = position.reshape(1, 1).expand(B, 1)
    q, k, v = qkv_project(cfg, params, x, positions)
    write_idx = cache_index % S if window is not None else cache_index
    write_idx = torch.clamp(write_idx, max=S - 1).long().reshape(1)
    cache_k = cache_k.index_copy(2, write_idx, k.to(cache_k.dtype))
    cache_v = cache_v.index_copy(2, write_idx, v.to(cache_v.dtype))
    valid = torch.clamp(cache_index + 1, max=S)
    o = attn_lib.decode_attention(q, cache_k, cache_v, valid,
                                  ring=window is not None)
    return out_project(params, o, x.dtype), cache_k, cache_v


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_defs(cfg: ModelConfig) -> Params:
    v = cfg.padded_vocab
    defs: Params = {"embedding": ParamDef((v, cfg.d_model), "embed", scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, v))
    return defs


def embed_tokens(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens: [B, S] integer -> [B, S, D] in ``dtype``.  ``F.embedding``,
    whose backward on the card sums a repeated token's rows in a fixed
    order (``index_select``'s accumulates them by atomics, so that two
    equal train steps could differ in the embedding's gradient bits)."""
    return F.embedding(tokens, params["embedding"]).to(dtype)


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B, S, padded vocab], a float32 product (exact float32
    on the card as long as TF32 matmul is off, which the models set)."""
    w = params["unembed"] if "unembed" in params else params["embedding"].T
    return torch.matmul(x.float(), w.float())
