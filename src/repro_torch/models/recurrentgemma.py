"""RecurrentGemma / Griffin hybrid [arXiv:2402.19427]: port of
``repro/models/recurrentgemma.py``.

Block pattern (recurrent, recurrent, attention): the RG-LRU diagonal
linear recurrence after a causal temporal convolution (width 4) in the
recurrent blocks, local sliding-window MQA in the attention blocks, a
GeGLU MLP in every block.  Names and the unrolled parameter tree (a list
of heterogeneous blocks) are the JAX module's, so that
``params.from_jax_params`` carries its tree across unchanged.

Entry points:
  param_defs(cfg)                         -> ParamDef tree
  forward(cfg, params, batch, ...)        -> final hidden states [B,S,D], aux 0
  prefill(cfg, params, batch, ...)        -> (last hidden [B,D], RGCache)
  decode_step(cfg, params, cache, batch)  -> (logits [B,V], RGCache)

Where the work goes: prefill attention -> ``kernels.flash_attention``
(one launch an attention block; the banded form where the prompt is
longer than the window, whose K/V then go to a ring of ``window``
slots); projections, gates and MLPs -> plain products; the RG-LRU over a
prompt -> ``rg_lru``, a log-depth scan in plain tensor code (the JAX
module runs ``lax.associative_scan`` outside any Pallas kernel); the
temporal convolution -> four shifted products, as in JAX; decode ->
``rg_lru_step`` and plain decode attention, no kernel.

The RG-LRU's decay is one a channel, so the chunked WKV kernel (one
decay a K row, shared by every V column) cannot compute it.

The cache is the reference's, quirks included: K/V of the prompt's length
(a ring of ``window`` slots past it), and a decode step writes at ``step``
(``step % S`` on a ring) clamped to S - 1.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, load_cast
from repro_torch.models.transformer import _to_ring, cache_len

Params = Dict[str, Any]

LRU_C = 8.0  # Griffin's fixed gate temperature


class RGCache(NamedTuple):
    """Per-layer decode state (heterogeneous across the block pattern)."""
    rec_h: List[torch.Tensor]       # [B, W] float32 per recurrent layer
    conv_state: List[torch.Tensor]  # [B, conv_width-1, W] per recurrent layer
    attn_k: List[torch.Tensor]      # [B, Hkv, S, D] per attention layer
    attn_v: List[torch.Tensor]
    step: torch.Tensor              # 0-d int32 on the device


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _recurrent_defs(cfg: ModelConfig) -> Params:
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv1d_width
    return {
        "wy": ParamDef((d, w)),
        "wx": ParamDef((d, w)),
        "conv_w": ParamDef((cw, w)),
        "conv_b": ParamDef((w,), "zeros"),
        "gate_i": ParamDef((w, w)),
        "gate_i_b": ParamDef((w,), "zeros"),
        "gate_r": ParamDef((w, w)),
        "gate_r_b": ParamDef((w,), "zeros"),
        "lam": ParamDef((w,), "uniform_decay"),
        "wo": ParamDef((w, d)),
    }


def param_defs(cfg: ModelConfig) -> Params:
    blocks: List[Params] = []
    for kind in cfg.block_pattern:
        b: Params = {"ln1": L.norm_defs(cfg), "ln2": L.norm_defs(cfg),
                     "mlp": L.mlp_defs(cfg)}
        if kind == "recurrent":
            b["rec"] = _recurrent_defs(cfg)
        else:
            b["attn"] = L.attention_defs(cfg)
        blocks.append(b)
    return {"embed": L.embedding_defs(cfg), "blocks": blocks,
            "ln_f": L.norm_defs(cfg)}


def compute_dtype_leaves(cfg: ModelConfig) -> List[str]:
    """The leaves the JAX functions cast to the compute dtype at every use:
    the embedding, the recurrent block's projections and convolution, the
    attention projections and the MLP.  The gates and ``lam`` stay float32,
    as the RG-LRU reads them."""
    out = ["embed.embedding"]
    for i, kind in enumerate(cfg.block_pattern):
        names = ([f"rec.{n}" for n in ("wy", "wx", "wo", "conv_w", "conv_b")]
                 if kind == "recurrent"
                 else [f"attn.{n}" for n in ("wq", "wk", "wv", "wo")])
        out += [f"blocks.{i}.{n}" for n in names + ["mlp.wi", "mlp.wg", "mlp.wo"]]
    return out


def load_params(cfg: ModelConfig, tree: Params, *,
                device: "torch.device | str" = "cuda") -> Params:
    """``params.load_cast`` of the hybrid's tree: float32 tensors on
    ``device`` (the card by default), ``compute_dtype_leaves`` in
    ``cfg.compute_dtype``."""
    return load_cast(cfg, tree, param_defs(cfg), compute_dtype_leaves(cfg),
                     device=device)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _gates(rec: Params, u: torch.Tensor):
    """(a, sqrt(1 - a^2) * i * u), float32, of the recurrence
    h_t = a_t h_{t-1} + b_t."""
    uf = u.float()
    i_gate = torch.sigmoid(uf @ rec["gate_i"].float() + rec["gate_i_b"].float())
    r_gate = torch.sigmoid(uf @ rec["gate_r"].float() + rec["gate_r_b"].float())
    log_a = -LRU_C * torch.nn.functional.softplus(rec["lam"].float()) * r_gate
    a = torch.exp(log_a)                                      # (0, 1)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_gate * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, by Hillis-Steele
    doubling: ceil(log2 T) rounds of the combine (a1, b1) o (a2, b2) =
    (a1 a2, a2 b1 + b2) of the JAX module, each element with the one ``d``
    steps before it, out of place.  A fixed number of kernels for a given
    T (so a prefill captures).  A product of ``a`` may underflow to 0,
    which is harmless; nothing is exponentiated from a sum."""
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], 1)
        if 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rg_lru(rec: Params, u: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """u: [B,T,W].  Returns (y [B,T,W] in u's dtype, h_last [B,W] float32)."""
    a, b = _gates(rec, u)
    if h0 is not None:
        # the incoming state folded into the first step
        b[:, 0] += a[:, 0] * h0
    h = linear_scan(a, b)
    return h.to(u.dtype), h[:, -1]


def rg_lru_step(rec: Params, u: torch.Tensor, h: torch.Tensor):
    """One decode step.  u: [B,W]; h: [B,W] float32 -> (y in u's dtype,
    new h float32)."""
    a, b = _gates(rec, u)
    h_new = a * h + b
    return h_new.to(u.dtype), h_new


# ---------------------------------------------------------------------------
# Temporal depthwise conv (causal, width cw)
# ---------------------------------------------------------------------------


def causal_conv1d(rec: Params, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x: [B,T,W]; state: [B,cw-1,W] trailing context (decode) or None.
    Returns (y [B,T,W], new_state [B,cw-1,W])."""
    w = rec["conv_w"].to(x.dtype)                            # [cw, W]
    b = rec["conv_b"].to(x.dtype)
    cw, T = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                              # [B,T+cw-1,W]
    y = xp[:, 0:T] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + T] * w[i]
    return y + b, xp[:, T:]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _recurrent_block(cfg: ModelConfig, rec: Params, u: torch.Tensor):
    """Full-sequence recurrent mixing block (no incoming state) -> (out,
    h_last, conv state)."""
    dtype = u.dtype
    y_branch = L.activation("gelu", u @ rec["wy"].to(dtype))
    x_branch = u @ rec["wx"].to(dtype)
    x_branch, new_conv = causal_conv1d(rec, x_branch)
    x_branch, h_last = rg_lru(rec, x_branch)
    out = (y_branch * x_branch) @ rec["wo"].to(dtype)
    return out, h_last, new_conv


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device).expand(B, S)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, remat: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D] post-ln_f, aux 0).  ``remat``:
    each block under ``layers.remat_call``."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    positions = _positions(x)

    def block(kind, bp, x):
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            h = _recurrent_block(cfg, bp["rec"], h)[0]
        else:
            h = L.attention_apply(cfg, bp["attn"], h, positions,
                                  window=cfg.window, kernels=kernels)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h)

    for kind, bp in zip(cfg.block_pattern, params["blocks"]):
        x = L.remat_call(block, kind, bp, x, remat=remat)
    x = L.norm_apply(cfg, params["ln_f"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(params["embed"], hidden)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: "torch.device | str" = "cuda") -> RGCache:
    W = cache_len(cfg, seq_len)
    dt = cfg.compute_dtype
    n_rec = sum(k == "recurrent" for k in cfg.block_pattern)
    n_attn = len(cfg.block_pattern) - n_rec
    kv = (batch, cfg.num_kv_heads, W, cfg.head_dim)
    return RGCache(
        rec_h=[torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                           device=device) for _ in range(n_rec)],
        conv_state=[torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width),
                                dtype=dt, device=device) for _ in range(n_rec)],
        attn_k=[torch.zeros(kv, dtype=dt, device=device) for _ in range(n_attn)],
        attn_v=[torch.zeros(kv, dtype=dt, device=device) for _ in range(n_attn)],
        step=torch.zeros((), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, **_) -> Tuple[torch.Tensor, RGCache]:
    """Run the full prompt, return (last hidden [B,D], cache).  One
    ``kernels.flash_attention`` an attention block."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    S = x.shape[1]
    W = cache_len(cfg, S)
    positions = _positions(x)
    rec_h, conv_state, attn_k, attn_v = [], [], [], []
    for kind, bp in zip(cfg.block_pattern, params["blocks"]):
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            h, h_last, cst = _recurrent_block(cfg, bp["rec"], h)
            rec_h.append(h_last)
            conv_state.append(cst)
        else:
            q, k, v = L.qkv_project(cfg, bp["attn"], h, positions)
            kr, vr = L.expand_kv(cfg, k, v)
            if cfg.window is not None and cfg.window < S:
                o = attn_lib.flash_attention_banded(q, kr, vr, cfg.window,
                                                    kernels=kernels)
            else:
                o = attn_lib.flash_attention(q, kr, vr, True, cfg.window,
                                             kernels=kernels)
            h = L.out_project(bp["attn"], o, x.dtype)
            attn_k.append(_to_ring(k, W) if W < S else k)
            attn_v.append(_to_ring(v, W) if W < S else v)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
    x = L.norm_apply(cfg, params["ln_f"], x)
    # step is filled on the device, so that the prefill can be captured
    cache = RGCache(rec_h=rec_h, conv_state=conv_state, attn_k=attn_k,
                    attn_v=attn_v,
                    step=torch.full((), S, dtype=torch.int32, device=x.device))
    return x[:, -1, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: RGCache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, RGCache]:
    """batch: {"tokens": [B,1]}.  Returns (logits [B,V] for the new token,
    updated cache).  No kernel: ``kernels`` is taken for the common step
    signature."""
    del kernels
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    step = cache.step
    rec_h, conv_state = list(cache.rec_h), list(cache.conv_state)
    attn_k, attn_v = list(cache.attn_k), list(cache.attn_v)
    ri = ai = 0
    for kind, bp in zip(cfg.block_pattern, params["blocks"]):
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            rec, dtype = bp["rec"], h.dtype
            y_branch = L.activation("gelu", h @ rec["wy"].to(dtype))
            x_branch = h @ rec["wx"].to(dtype)
            x_branch, conv_state[ri] = causal_conv1d(rec, x_branch, conv_state[ri])
            x_step, rec_h[ri] = rg_lru_step(rec, x_branch[:, 0], rec_h[ri])
            h = (y_branch * x_step[:, None]) @ rec["wo"].to(dtype)
            ri += 1
        else:
            h, attn_k[ai], attn_v[ai] = L.attention_decode_apply(
                cfg, bp["attn"], h, step, attn_k[ai], attn_v[ai], step,
                window=cfg.window)
            ai += 1
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
    x = L.norm_apply(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, RGCache(rec_h=rec_h, conv_state=conv_state, attn_k=attn_k,
                           attn_v=attn_v, step=step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` calls each kernel;
    ``decode_step`` calls none."""
    return {"flash_attention": sum(k == "attention" for k in cfg.block_pattern)}
