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

Under the sharded train step each block gathers its leaves inside the
remat'd function (``actshard.gathered``) and splits its heads, d_ff and
recurrence width over 'model' (``_recurrent_block``, ``layers``); the MQA
blocks' one KV head is replicated, and each rank projects it for its
query heads.  Under 'cp' (``actshard.seq``) a rank holds S / n consecutive
positions: the convolution reads the cw - 1 inputs before the rank's
block, the RG-LRU starts from the state the rank before left
(``collectives.chain``), and the attention blocks gather K / V
(``layers.attention_apply``); a serving prefill hands the last rank's
states into the cache's blocks.

The cache is the reference's, quirks included: K/V of the prompt's length
(a ring of ``window`` slots past it), and a decode step writes at ``step``
(``step % S`` on a ring) clamped to S - 1.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard
from repro_torch.models import layers as L
from repro_torch.models.layers import coll
from repro_torch.models.params import ParamDef, draw_cast, load_cast
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
        "wy": ParamDef((d, w), axes=("embed", "ff")),
        "wx": ParamDef((d, w), axes=("embed", "ff")),
        "conv_w": ParamDef((cw, w), axes=(None, "ff")),
        "conv_b": ParamDef((w,), "zeros", axes=("ff",)),
        "gate_i": ParamDef((w, w), axes=(None, "ff")),
        "gate_i_b": ParamDef((w,), "zeros", axes=("ff",)),
        "gate_r": ParamDef((w, w), axes=(None, "ff")),
        "gate_r_b": ParamDef((w,), "zeros", axes=("ff",)),
        "lam": ParamDef((w,), "uniform_decay", axes=("ff",)),
        "wo": ParamDef((w, d), axes=("ff", "embed")),
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


def init_on_device(cfg: ModelConfig, seed: int, *,
                   device: "torch.device | str" = "cuda") -> Params:
    """``params.draw_cast`` of the hybrid's tree: its weights drawn on
    ``device`` from ``seed``, the leaves ``load_params`` casts straight in
    ``cfg.compute_dtype``; ``load_params`` takes the tree as it is (its
    blocks are a list, not stacked, so each leaf is drawn whole)."""
    return draw_cast(cfg, seed, param_defs(cfg), compute_dtype_leaves(cfg), device=device)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _gates(rec: Params, u: torch.Tensor, u_whole: Optional[torch.Tensor] = None):
    """(a, sqrt(1 - a^2) * i * u), float32, of the recurrence
    h_t = a_t h_{t-1} + b_t.  ``u_whole``: the whole width that the gates'
    products read where ``u`` is the rank's block of channels (and the
    gates' columns are the rank's)."""
    uf = u.float()
    uw = uf if u_whole is None else u_whole.float()
    i_gate = torch.sigmoid(uw @ rec["gate_i"].float() + rec["gate_i_b"].float())
    r_gate = torch.sigmoid(uw @ rec["gate_r"].float() + rec["gate_r_b"].float())
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


def rg_lru(rec: Params, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
           u_whole: Optional[torch.Tensor] = None):
    """u: [B,T,W].  Returns (y [B,T,W] in u's dtype, h_last [B,W] float32).
    ``u_whole`` as ``_gates`` takes it."""
    a, b = _gates(rec, u, u_whole)
    if h0 is not None:
        # the incoming state folded into the first step
        b[:, 0] += a[:, 0] * h0
    h = linear_scan(a, b)
    return h.to(u.dtype), h[:, -1]


def rg_lru_step(rec: Params, u: torch.Tensor, h: torch.Tensor,
                u_whole: Optional[torch.Tensor] = None):
    """One decode step.  u: [B,W]; h: [B,W] float32 -> (y in u's dtype,
    new h float32).  ``u_whole`` as ``_gates`` takes it."""
    a, b = _gates(rec, u, u_whole)
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
    h_last, conv state).  Under ``actshard.split("ff")`` a rank computes
    its block of the W channels: ``wy`` / ``wx`` column-parallel, the
    convolution and the RG-LRU scan on W/tp channels, the gates' products
    on the convolution's output gathered over 'model' (their columns the
    rank's), ``wo`` row-parallel and summed over 'model'.  Under
    ``actshard.seq`` the rank's positions continue the rank before's: the
    convolution's state is the cw - 1 rows of ``x_branch`` before the
    rank's block, from as many ranks before it as hold them (one
    ``collectives.ppermute`` of each rank's last min(cw - 1, S/n) rows a
    rank back; zeros before the sequence's start), and the RG-LRU's h0 the
    rank before's h_last (``collectives.chain``)."""
    dtype = u.dtype
    tp = actshard.split("ff")
    if tp is not None:
        u = coll().copy_to(u, tp, "model")
    y_branch = L.activation("gelu", u @ rec["wy"].to(dtype))
    x_branch = u @ rec["wx"].to(dtype)
    sq = actshard.seq()
    conv_in = None
    if sq is not None:
        mesh, _, n = sq
        cw, T = rec["conv_w"].shape[0], x_branch.shape[1]
        m = min(cw - 1, T)
        hops = -(-(cw - 1) // m)
        tail = x_branch[:, T - m:]
        back = [coll().ppermute(tail, mesh, "model", [(i, i + j) for i in range(n - j)])
                if j < n else torch.zeros_like(tail) for j in range(hops, 0, -1)]
        conv_in = back[0] if hops == 1 else torch.cat(back, 1)[:, hops * m - (cw - 1):]
    x_branch, new_conv = causal_conv1d(rec, x_branch, conv_in)
    whole = None if tp is None else coll().all_gather(x_branch, tp, "model", -1)
    if sq is None:
        x_branch, h_last = rg_lru(rec, x_branch, u_whole=whole)
    else:
        B, W = x_branch.shape[0], x_branch.shape[2]
        x_branch, h_last = coll().chain(
            lambda h0: rg_lru(rec, x_branch, h0, whole), mesh, "model",
            like=torch.empty((B, W), dtype=torch.float32, device=u.device),
            anchor=x_branch)
    out = (y_branch * x_branch) @ rec["wo"].to(dtype)
    if tp is not None:
        out = coll().reduce_from(out, tp, "model")
    return out, h_last, new_conv


def _positions(x: torch.Tensor) -> torch.Tensor:
    """The rank's positions [B, S] (offset under 'cp')."""
    B, S = x.shape[0], x.shape[1]
    return actshard.positions(S, x.device).expand(B, S)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, remat: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D] post-ln_f, aux 0).  ``remat``:
    each block under ``layers.remat_call``."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    positions = _positions(x)

    def block(kind, bp, i, x):
        bp = actshard.gathered(bp, f"blocks.{i}")
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            h = _recurrent_block(cfg, bp["rec"], h)[0]
        else:
            h = L.attention_apply(cfg, bp["attn"], h, positions,
                                  window=cfg.window, kernels=kernels)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        return x + L.mlp_apply(cfg, bp["mlp"], h)

    for i, (kind, bp) in enumerate(zip(cfg.block_pattern, params["blocks"])):
        x = L.remat_call(block, kind, bp, i, x, remat=remat)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
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
    ``kernels.flash_attention`` an attention block (``layers.
    attention_apply``).  Under a serving layout each block gathers its
    leaves at use and splits its products as in training, and the rank
    keeps its blocks of the cache (``actshard.to_cache``): ``rec_h`` and
    ``conv_state`` its W/tp channels, the MQA ring its slots.  Under 'cp'
    the rank runs its S / n positions: the MQA cache (a ring past the
    window) is built from the K / V the attention gathered and cut to the
    rank's slots, and ``rec_h``, ``conv_state`` and the last hidden state
    are the last rank's (``actshard.seq_last``)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    S = actshard.seq_len(x.shape[1])
    W = cache_len(cfg, S)
    positions = _positions(x)
    ch = 1 if actshard.split("ff") is not None else None
    rec_h, conv_state, attn_k, attn_v = [], [], [], []
    for i, (kind, bp) in enumerate(zip(cfg.block_pattern, params["blocks"])):
        bp = actshard.gathered(bp, f"blocks.{i}")
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            h, h_last, cst = _recurrent_block(cfg, bp["rec"], h)
            rec_h.append(actshard.seq_last(h_last, "rec_h", ch))
            conv_state.append(actshard.seq_last(cst, "conv_state",
                                                None if ch is None else 2))
        else:
            h, k, v = L.attention_apply(cfg, bp["attn"], h, positions,
                                        window=cfg.window, kernels=kernels,
                                        return_kv=True)
            kv_dim = 1 if L.kv_heads_split() else None
            attn_k.append(actshard.to_cache("attn_k", _to_ring(k, W) if W < S else k,
                                            kv_dim))
            attn_v.append(actshard.to_cache("attn_v", _to_ring(v, W) if W < S else v,
                                            kv_dim))
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    # step is filled on the device, so that the prefill can be captured
    cache = RGCache(rec_h=rec_h, conv_state=conv_state, attn_k=attn_k,
                    attn_v=attn_v,
                    step=torch.full((), S, dtype=torch.int32, device=x.device))
    return actshard.seq_last(x[:, -1, :]), cache


def _recurrent_step(cfg: ModelConfig, rec: Params, h: torch.Tensor,
                    conv_state: torch.Tensor, rec_h: torch.Tensor):
    """One token through a recurrent block -> (out [B,1,D], conv state,
    h).  Under ``actshard.split("ff")`` the products are
    ``_recurrent_block``'s: ``wy`` / ``wx`` column-parallel, the
    convolution and the RG-LRU step on the rank's W/tp channels with the
    gates on the convolution's output gathered over 'model', ``wo``
    row-parallel and summed over 'model'.  The cache's blocks are carried
    to those channels and back (``actshard.from_cache`` / ``to_cache``)."""
    dtype = h.dtype
    tp = actshard.split("ff")
    ch = None if tp is None else 1
    conv_state = actshard.from_cache("conv_state", conv_state, None if ch is None else 2)
    rec_h = actshard.from_cache("rec_h", rec_h, ch)
    if tp is not None:
        h = coll().copy_to(h, tp, "model")
    y_branch = L.activation("gelu", h @ rec["wy"].to(dtype))
    x_branch = h @ rec["wx"].to(dtype)
    x_branch, conv_state = causal_conv1d(rec, x_branch, conv_state)
    whole = None if tp is None else coll().all_gather(x_branch[:, 0], tp, "model", -1)
    x_step, rec_h = rg_lru_step(rec, x_branch[:, 0], rec_h, u_whole=whole)
    out = (y_branch * x_step[:, None]) @ rec["wo"].to(dtype)
    if tp is not None:
        out = coll().reduce_from(out, tp, "model")
    return (out, actshard.to_cache("conv_state", conv_state, None if ch is None else 2),
            actshard.to_cache("rec_h", rec_h, ch))


def decode_step(cfg: ModelConfig, params: Params, cache: RGCache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, RGCache]:
    """batch: {"tokens": [B,1]}.  Returns (logits [B,V] for the new token,
    updated cache).  No kernel: ``kernels`` is taken for the common step
    signature.  Under a serving layout each block gathers its leaves at
    use, the recurrent blocks split as ``_recurrent_step`` says, the
    attention blocks follow the ring's split over slots
    (``layers.attention_decode_apply``)."""
    del kernels
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    step = cache.step
    rec_h, conv_state = list(cache.rec_h), list(cache.conv_state)
    attn_k, attn_v = list(cache.attn_k), list(cache.attn_v)
    ri = ai = 0
    for i, (kind, bp) in enumerate(zip(cfg.block_pattern, params["blocks"])):
        bp = actshard.gathered(bp, f"blocks.{i}")
        h = L.norm_apply(cfg, bp["ln1"], x)
        if kind == "recurrent":
            h, conv_state[ri], rec_h[ri] = _recurrent_step(
                cfg, bp["rec"], h, conv_state[ri], rec_h[ri])
            ri += 1
        else:
            h, attn_k[ai], attn_v[ai] = L.attention_decode_apply(
                cfg, bp["attn"], h, step, attn_k[ai], attn_v[ai], step,
                window=cfg.window, field="attn_k")
            ai += 1
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        x = x + L.mlp_apply(cfg, bp["mlp"], h)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, RGCache(rec_h=rec_h, conv_state=conv_state, attn_k=attn_k,
                           attn_v=attn_v, step=step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` calls each kernel;
    ``decode_step`` calls none."""
    return {"flash_attention": sum(k == "attention" for k in cfg.block_pattern)}
