"""RWKV-6 "Finch" [arXiv:2404.05892] — attention-free LM, inference.

Port of ``repro/models/rwkv6.py`` with its names, nested parameter tree
and stacked ``[L, ...]`` layouts, so that ``params.from_jax_params``
carries the JAX tree across unchanged.  Functions take the parameter tree
as the JAX ones do; the layers are walked by a Python loop.

Where the work goes:

- the WKV recurrence of a prompt (T > 1) -> ``kernels.wkv_chunked``, the
  hand-written chunked kernel on a CUDA tensor (``ops``, the default) or
  the per-token ``ref.wkv_ref`` (``kernels=ref.PLAIN``, or any CPU
  tensor).  The layout goes [B,T,H,K] -> [B*H,T,K] and ``u = faaaa`` is
  repeated over the batch.  ``forward`` and ``prefill`` start from the
  zero state (``state=None``); ``time_mix`` at T > 1 from a given state
  hands it to the kernel, as the reference's ``wkv_chunked(..., state,
  chunk)`` starts from it;
- one token (decode) -> ``wkv_recurrent_step``, plain tensor code, as in
  the JAX package, where decode reaches no kernel either;
- ``channel_mix`` and every projection stay plain matrix products
  (``torch.matmul``), as they are XLA's in the JAX package.

Under the sharded train step (``actshard.split("ff")``, which the layout
gives only where the heads split too) a rank computes its block of the
heads: the time mix's ``wr`` / ``wk`` / ``wv`` / ``wg`` column-parallel
from the replicated token-shift mixes, the WKV kernel on [B*H/tp, T, K],
``faaaa`` and the per-head group norm on the rank's heads, ``decay`` and
``td_w2`` (replicated, on 'embed') cut to the rank's channels, ``wo``
row-parallel and summed over 'model'; the channel mix as ``channel_mix``
says.  The LoRA mixes and norms stay replicated.  Under 'cp'
(``actshard.seq``) a rank holds S / n consecutive tokens: each token
shift's x_prev is the rank before's last row of the same normed input
(``collectives.ppermute``; zeros on rank 0, the one-process x_prev), and
each layer's WKV starts from the state the rank before left
(``collectives.chain``: the ranks launch the kernel in turn).  Serving
under 'cp', the prefill hands the last rank's states and token shifts
into the cache's blocks (their heads and d_model over 'model'), and a
decode step, its one token whole on every rank of 'model' and the weights
whole, gathers the states' heads over 'model' and runs every head
(``actshard.from_cache``).

``wkv_chunked`` here is the JAX module's XLA-level chunked form with a
carried state, kept as a plain torch function that the tests hold against
JAX; no path calls it when a card is present.

``load_params`` casts, once, every leaf that the JAX functions cast to
the compute dtype at each use (the projections, LoRA and mix vectors, the
embedding table); the rest stays float32 as JAX reads it (decay,
``td_w2``, ``faaaa``, norms, unembedding).  The rounding is the same, and
a bfloat16 decode step then reads 2.9 GB of matrices instead of casting
6.4 GB of float32 weights on every step.  The ``.to(dtype)`` calls in the
functions are then no-ops.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard
from repro_torch.models import layers as L
from repro_torch.models.layers import coll
from repro_torch.models.params import ParamDef, draw_cast, load_cast, per_layer

Params = Dict[str, Any]

LORA_MIX = 32     # token-shift LoRA rank
LORA_DECAY = 64   # decay LoRA rank


class RWKVCache(NamedTuple):
    state: torch.Tensor      # [L, B, H, K, V] wkv state, float32
    shift_tm: torch.Tensor   # [L, B, D] previous token (time-mix)
    shift_cm: torch.Tensor   # [L, B, D] previous token (channel-mix)
    step: torch.Tensor       # int32 scalar


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def param_defs(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    f = cfg.d_ff
    h = d // cfg.wkv_head_dim
    k = cfg.wkv_head_dim
    ld = (cfg.num_layers,)
    ax = ("layers",)

    def vec(init="zeros"):
        return ParamDef(ld + (d,), init, axes=ax + ("embed",))

    tm = {
        "maa_x": vec(), "maa_w": vec(), "maa_k": vec(), "maa_v": vec(),
        "maa_r": vec(), "maa_g": vec(),
        "maa_w1": ParamDef(ld + (d, 5 * LORA_MIX), axes=ax + ("embed", None)),
        "maa_w2": ParamDef(ld + (5, LORA_MIX, d), axes=ax + (None, None, "embed")),
        "decay": ParamDef(ld + (d,), "uniform_decay", axes=ax + ("embed",)),
        "td_w1": ParamDef(ld + (d, LORA_DECAY), axes=ax + ("embed", None)),
        "td_w2": ParamDef(ld + (LORA_DECAY, d), axes=ax + (None, "embed")),
        "faaaa": ParamDef(ld + (h, k), axes=ax + ("heads", None)),
        "wr": ParamDef(ld + (d, d), axes=ax + ("embed", "ff")),
        "wk": ParamDef(ld + (d, d), axes=ax + ("embed", "ff")),
        "wv": ParamDef(ld + (d, d), axes=ax + ("embed", "ff")),
        "wg": ParamDef(ld + (d, d), axes=ax + ("embed", "ff")),
        "wo": ParamDef(ld + (d, d), axes=ax + ("ff", "embed")),
        # ln_x acts on the head-grouped dim: sharded as the heads are
        "lnx_scale": ParamDef(ld + (d,), "ones", axes=ax + ("ff",)),
        "lnx_bias": ParamDef(ld + (d,), "zeros", axes=ax + ("ff",)),
    }
    cm = {
        "maa_k": vec(), "maa_r": vec(),
        "wk": ParamDef(ld + (d, f), axes=ax + ("embed", "ff")),
        "wv": ParamDef(ld + (f, d), axes=ax + ("ff", "embed")),
        "wr": ParamDef(ld + (d, d), axes=ax + ("embed", "ff")),
    }
    block = {
        "ln1": L.norm_defs(cfg, ld), "tm": tm,
        "ln2": L.norm_defs(cfg, ld), "cm": cm,
    }
    return {
        "embed": L.embedding_defs(cfg),
        "ln0": L.norm_defs(cfg),
        "blocks": block,
        "ln_f": L.norm_defs(cfg),
    }


# the leaves the JAX functions cast to the compute dtype at every use
COMPUTE_DTYPE_LEAVES = (
    ["embed.embedding"]
    + [f"blocks.tm.{n}" for n in ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r",
                                  "maa_g", "maa_w1", "maa_w2", "td_w1", "wr",
                                  "wk", "wv", "wg", "wo")]
    + [f"blocks.cm.{n}" for n in ("maa_k", "maa_r", "wk", "wv", "wr")])


def load_params(cfg: ModelConfig, tree: Params, *,
                device: "torch.device | str" = "cuda") -> Params:
    """``params.load_cast`` of RWKV-6's tree: float32 tensors on
    ``device`` (the card by default), ``COMPUTE_DTYPE_LEAVES`` in
    ``cfg.compute_dtype``."""
    return load_cast(cfg, tree, param_defs(cfg), COMPUTE_DTYPE_LEAVES, device=device)


def init_on_device(cfg: ModelConfig, seed: int, *,
                   device: "torch.device | str" = "cuda",
                   layers: Optional[int] = None) -> Params:
    """``params.draw_cast`` of RWKV-6's tree: its weights drawn on
    ``device`` from ``seed``, ``COMPUTE_DTYPE_LEAVES`` straight in
    ``cfg.compute_dtype``; ``load_params`` takes the tree as it is.
    ``layers=n``: the first n layer slices only, the same numbers."""
    return draw_cast(cfg, seed, param_defs(cfg), COMPUTE_DTYPE_LEAVES, device=device,
                     layers=layers)


# ---------------------------------------------------------------------------
# WKV6 core — chunked (XLA-level form, tests) and recurrent (decode)
# ---------------------------------------------------------------------------


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """r, k, logw: [B,T,H,K]; v: [B,T,H,V]; u: [H,K]; state: [B,H,K,V].

    Returns (out [B,T,H,V], new_state).  logw = log(decay) <= 0.  The
    chunk shrinks to a power-of-two divisor of T, as in the JAX module.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = min(chunk, T)
    while T % C != 0:
        C //= 2
    n = T // C

    def resh(x):   # -> [n, B, H, C, *]
        return x.reshape(B, n, C, H, -1).permute(1, 0, 3, 2, 4).float()

    rs, ks, vs, ws = resh(r), resh(k), resh(v), resh(logw)
    tri_lower = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
    uf = u.float()
    S = state.float()
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rs[i], ks[i], vs[i], ws[i]              # [B,H,C,K/V]
        b = torch.cumsum(wc, dim=2)
        b_prev = b - wc
        inter = torch.einsum("bhck,bhkv->bhcv", rc * torch.exp(b_prev), S)
        expo = torch.exp(torch.clamp(
            b_prev[:, :, :, None, :] - b[:, :, None, :, :], max=0.0))
        A = torch.einsum("bhtk,bhsk,bhtsk->bhts", rc, kc, expo)
        A = torch.where(tri_lower[None, None], A, torch.zeros_like(A))
        diag = torch.einsum("bhck,hk,bhck->bhc", rc, uf, kc)
        intra = torch.einsum("bhts,bhsv->bhtv", A, vc) + diag[..., None] * vc
        outs.append(inter + intra)
        b_end = b[:, :, -1:, :]
        k_decayed = kc * torch.exp(b_end - b)
        S = torch.exp(b_end.squeeze(2))[..., None] * S + \
            torch.einsum("bhck,bhcv->bhkv", k_decayed, vc)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return out.to(r.dtype), S


def wkv_recurrent_step(r, k, v, logw, u, state):
    """Single-token recurrence.  r, k, logw: [B,H,K]; v: [B,H,V]; u: [H,K];
    state: [B,H,K,V] float32 -> (out [B,H,V], new_state).  In float32,
    the read-out the reference's einsum (a float32 product on the card is
    exact float32: TF32 is off, ``params.load_cast``)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    at = kf[..., :, None] * vf[..., None, :]                      # [B,H,K,V]
    full = state + u.float()[None, :, :, None] * at
    out = torch.einsum("bhk,bhkv->bhv", rf, full)
    state = torch.exp(logw.float())[..., None] * state + at
    return out.to(r.dtype), state


def _wkv_kernel(kernels, r, k, v, logw, u, chunk: int,
                state: Optional[torch.Tensor] = None):
    """[B,T,H,K] operands -> the [B*H,T,K] kernel layout and back, from
    ``state`` [B,H,K,V] (None: zero).  Returns (out [B,T,H,V], state
    [B,H,K,V])."""
    B, T, H, K = r.shape
    V = v.shape[-1]

    def flat(x):   # a dense copy: at B = 1 the reshape alone is a strided view
        return x.permute(0, 2, 1, 3).reshape(B * H, T, x.shape[-1]).contiguous()

    kw = ({} if state is None else
          {"state": state.float().reshape(B * H, K, V).contiguous()})
    out, state = kernels.wkv_chunked(flat(r), flat(k), flat(v), flat(logw),
                                     u.repeat(B, 1), chunk=chunk, **kw)
    return (out.reshape(B, H, T, V).permute(0, 2, 1, 3),
            state.reshape(B, H, K, V))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """shifted(x)[t] = x[t-1]; x_prev fills t=0.  x: [B,T,D], x_prev: [B,D]."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(tm: Params, x, sx):
    """RWKV6 data-dependent token-shift interpolation.
    Returns xw, xk, xv, xr, xg  (each [B,T,D])."""
    dtype = x.dtype
    xxx = x + sx * tm["maa_x"].to(dtype)
    flat = torch.tanh(xxx @ tm["maa_w1"].to(dtype))                # [B,T,5*R]
    B, T, _ = flat.shape
    flat = flat.reshape(B, T, 5, LORA_MIX).permute(2, 0, 1, 3)
    mix = torch.einsum("pbtr,prd->pbtd", flat, tm["maa_w2"].to(dtype))
    names = ["maa_w", "maa_k", "maa_v", "maa_r", "maa_g"]
    return [x + sx * (tm[nm].to(dtype) + mix[i]) for i, nm in enumerate(names)]


def _group_norm(x: torch.Tensor, scale, bias, heads: int) -> torch.Tensor:
    """Per-head LayerNorm over the head dim (RWKV ln_x). x: [B,T,D]."""
    B, T, D = x.shape
    xh = x.reshape(B, T, heads, D // heads).float()
    mean = xh.mean(-1, keepdim=True)
    var = torch.square(xh - mean).mean(-1, keepdim=True)
    xh = (xh - mean) * torch.rsqrt(var + 1e-5)
    out = xh.reshape(B, T, D) * scale.float() + bias.float()
    return out.to(x.dtype)


def time_mix(cfg: ModelConfig, tm: Params, x: torch.Tensor,
             x_prev: torch.Tensor, state: Optional[torch.Tensor], chunk: int,
             kernels=ops):
    """Returns (out [B,T,D], new_x_prev [B,D], new_state [B,H,K,V]).
    ``state=None`` is the zero state; at T > 1 the kernel starts from the
    given one.  Under ``actshard.seq`` the WKV starts from the state the
    rank before on 'model' left (``collectives.chain``)."""
    dtype = x.dtype
    B, T, _ = x.shape
    K = cfg.wkv_head_dim
    H = tm["faaaa"].shape[-2]               # the rank's heads under TP
    D = H * K
    sx = _token_shift(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(tm, x, sx)
    lora = torch.tanh(xw @ tm["td_w1"].to(dtype))
    decay, td_w2 = tm["decay"], tm["td_w2"]
    tp = actshard.split("ff")
    if tp is not None:
        C = coll()
        xk, xv, xr, xg = torch.unbind(C.copy_to(torch.stack([xk, xv, xr, xg]), tp, "model"))
        lora = C.copy_to(lora, tp, "model")
        c0 = C.axis_index(tp, "model") * D
        decay = C.copy_to(decay, tp, "model").narrow(-1, c0, D)
        td_w2 = C.copy_to(td_w2, tp, "model").narrow(-1, c0, D)

    r = (xr @ tm["wr"].to(dtype)).reshape(B, T, H, K)
    k = (xk @ tm["wk"].to(dtype)).reshape(B, T, H, K)
    v = (xv @ tm["wv"].to(dtype)).reshape(B, T, H, K)
    g = F.silu(xg @ tm["wg"].to(dtype))

    ww = decay.float() + lora.float() @ td_w2.float()
    logw = -torch.exp(ww).reshape(B, T, H, K)                      # log decay <= 0

    if T == 1:
        if state is None:
            state = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
        out1, state = wkv_recurrent_step(
            r[:, 0], k[:, 0], v[:, 0], logw[:, 0], tm["faaaa"], state)
        out = out1[:, None]
    elif actshard.seq() is None:
        out, state = _wkv_kernel(kernels, r, k, v, logw, tm["faaaa"], chunk, state)
    else:       # from the state the rank before left (rank 0: ``state``)
        mesh = actshard.seq()[0]
        out, state = coll().chain(
            lambda s0: _wkv_kernel(kernels, r, k, v, logw, tm["faaaa"], chunk,
                                   state if s0 is None else s0),
            mesh, "model", like=torch.empty((B, H, K, K), dtype=torch.float32,
                                            device=x.device), anchor=r)
    out = out.reshape(B, T, D)
    out = _group_norm(out, tm["lnx_scale"], tm["lnx_bias"], H)
    out = (out * g) @ tm["wo"].to(dtype)
    if tp is not None:
        out = coll().reduce_from(out, tp, "model")
    return out, x[:, -1, :], state


def channel_mix(cm: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Returns (out [B,T,D], new x_prev).  Under ``actshard.split("ff")``:
    ``wk`` column-parallel and ``wv`` row-parallel over the rank's d_ff
    block, the gate ``wr`` column-parallel and gathered over 'model' to
    gate the d-wide sum."""
    dtype = x.dtype
    sx = _token_shift(x, x_prev) - x
    xk = x + sx * cm["maa_k"].to(dtype)
    xr = x + sx * cm["maa_r"].to(dtype)
    tp = actshard.split("ff")
    if tp is not None:
        xk, xr = torch.unbind(coll().copy_to(torch.stack([xk, xr]), tp, "model"))
    kk = F.relu(xk @ cm["wk"].to(dtype))
    kv = (kk * kk) @ cm["wv"].to(dtype)
    r = torch.sigmoid(xr @ cm["wr"].to(dtype))
    if tp is not None:
        kv = coll().reduce_from(kv, tp, "model")
        r = coll().gather_from(r, tp, "model", -1)
    return r * kv, x[:, -1, :]


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------


def _blocks(cfg: ModelConfig, params: Params, x: torch.Tensor, kernels,
            cache: Optional[RWKVCache] = None, remat: bool = False):
    """The residual stack; returns (x, per-layer states, shift_tm,
    shift_cm).  Without a cache every layer starts from zeros.  ``remat``:
    each layer under ``layers.remat_call``."""
    n = cfg.num_layers
    if cache is None:
        zeros = torch.zeros((x.shape[0], x.shape[2]), dtype=cfg.compute_dtype,
                            device=x.device)
        prev_tm, prev_cm, states = [zeros] * n, [zeros] * n, [None] * n
    else:
        prev_tm, prev_cm, states = cache.shift_tm, cache.shift_cm, cache.state
    st, sh_tm, sh_cm = [], [], []

    sq = actshard.seq()

    def from_rank_before(h, prev):
        """The rank before's last row of ``h`` under 'cp' (zeros on rank
        0), else ``prev``."""
        if sq is None:
            return prev
        mesh, _, n_m = sq
        return coll().ppermute(h[:, -1, :], mesh, "model",
                               [(i, i + 1) for i in range(n_m - 1)])

    def layer(bp, x, prev_tm, prev_cm, state):
        bp = actshard.gathered(bp, "blocks")
        h = L.norm_apply(cfg, bp["ln1"], x)
        h, s_tm, s = time_mix(cfg, bp["tm"], h, from_rank_before(h, prev_tm),
                              state, cfg.wkv_chunk, kernels)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        h, s_cm = channel_mix(bp["cm"], h, from_rank_before(h, prev_cm))
        return x + h, s, s_tm, s_cm

    for i, bp in enumerate(per_layer(params["blocks"], n)):
        x, s, s_tm, s_cm = L.remat_call(layer, bp, x, prev_tm[i], prev_cm[i],
                                        states[i], remat=remat)
        st.append(s)
        sh_tm.append(s_tm)
        sh_cm.append(s_cm)
    return x, st, sh_tm, sh_cm


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, remat: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch["tokens"]: [B, T] -> (hidden [B, T, D], aux loss 0)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    x = L.norm_apply(cfg, actshard.gathered(params["ln0"], "ln0"), x)
    x, _, _, _ = _blocks(cfg, params, x, kernels, remat=remat)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(params["embed"], hidden)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: "torch.device | str" = "cuda") -> RWKVCache:
    del seq_len  # state size is O(1) in sequence length
    D = cfg.d_model
    H = D // cfg.wkv_head_dim
    K = cfg.wkv_head_dim
    nl = cfg.num_layers
    return RWKVCache(
        state=torch.zeros((nl, batch, H, K, K), dtype=torch.float32, device=device),
        shift_tm=torch.zeros((nl, batch, D), dtype=cfg.compute_dtype, device=device),
        shift_cm=torch.zeros((nl, batch, D), dtype=cfg.compute_dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            kernels=ops, **_) -> Tuple[torch.Tensor, RWKVCache]:
    """batch["tokens"]: [B, T] -> (last hidden [B, D], cache).  Every
    layer's recurrence runs from the zero state through
    ``kernels.wkv_chunked``: one launch a layer on the card (on the rank's
    H/tp heads under a serving layout, whose cache blocks
    ``_to_cache_blocks`` makes).  Under 'cp' the rank runs its T / n
    tokens from the state the rank before left, and the states, token
    shifts and last hidden state are the last rank's
    (``actshard.seq_last``)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    x = L.norm_apply(cfg, actshard.gathered(params["ln0"], "ln0"), x)
    T = actshard.seq_len(x.shape[1])
    x, st, sh_tm, sh_cm = _blocks(cfg, params, x, kernels)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    # step is filled on the device: a copy from the host's pageable memory
    # (torch.tensor(T, device=...)) cannot be captured into a CUDA graph
    cache = _to_cache_blocks(st, sh_tm, sh_cm,
                             torch.full((), T, dtype=torch.int32, device=x.device))
    return actshard.seq_last(x[:, -1, :]), cache


def _state_dim():
    """The dim of a layer's state [B,H,K,V] that the rank computes its
    'model' block of (its heads, where the time mix splits them), else
    None."""
    return 1 if actshard.split("ff") is not None else None


def _to_cache_blocks(st, sh_tm, sh_cm, step) -> RWKVCache:
    """The layers' states and token shifts as the rank computed them (the
    states on its heads where the time mix splits them, the shifts whole)
    -> the rank's blocks of the cache (``actshard.to_cache``): the states'
    heads and the shifts' d_model over 'model' where ``cache_pspecs``
    splits them; under a 'cp' prefill the last rank's, block r sent to
    rank r (``actshard.seq_last``)."""
    sd = _state_dim()
    return RWKVCache(
        state=torch.stack([actshard.seq_last(s, "state", sd) for s in st]),
        shift_tm=torch.stack([actshard.seq_last(s, "shift_tm") for s in sh_tm]),
        shift_cm=torch.stack([actshard.seq_last(s, "shift_cm") for s in sh_cm]),
        step=step)


def decode_step(cfg: ModelConfig, params: Params, cache: RWKVCache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, RWKVCache]:
    """batch["tokens"]: [B, 1] -> (logits [B, padded vocab], cache).  Under
    a serving layout the rank's blocks of the cache are carried to what the
    layers compute with (``actshard.from_cache``: the token shifts gathered
    over 'model', the states as the time mix splits its heads, gathered
    whole under 'cp') and back."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    x = L.norm_apply(cfg, actshard.gathered(params["ln0"], "ln0"), x)
    sd = _state_dim()
    cache = RWKVCache(
        state=[actshard.from_cache("state", s, sd) for s in cache.state],
        shift_tm=[actshard.from_cache("shift_tm", s) for s in cache.shift_tm],
        shift_cm=[actshard.from_cache("shift_cm", s) for s in cache.shift_cm],
        step=cache.step)
    x, st, sh_tm, sh_cm = _blocks(cfg, params, x, kernels, cache)
    x = L.norm_apply(cfg, actshard.gathered(params["ln_f"], "ln_f"), x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, _to_cache_blocks(st, sh_tm, sh_cm, cache.step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` (T > 1) calls each
    kernel; ``decode_step`` calls none."""
    return {"wkv_chunked": cfg.num_layers}
