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
  repeated over the batch.  Like the TPU kernel it runs from a zero
  state: ``forward`` and ``prefill`` start there (``state=None``), and
  ``time_mix`` raises if asked for T > 1 from a non-zero state, which no
  caller does;
- one token (decode) -> ``wkv_recurrent_step``, plain tensor code, as in
  the JAX package, where decode reaches no kernel either;
- ``channel_mix`` and every projection stay plain matrix products
  (``torch.matmul``), as they are XLA's in the JAX package.

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
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, load_cast, per_layer

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

    def vec(init="zeros"):
        return ParamDef(ld + (d,), init)

    tm = {
        "maa_x": vec(), "maa_w": vec(), "maa_k": vec(), "maa_v": vec(),
        "maa_r": vec(), "maa_g": vec(),
        "maa_w1": ParamDef(ld + (d, 5 * LORA_MIX)),
        "maa_w2": ParamDef(ld + (5, LORA_MIX, d)),
        "decay": ParamDef(ld + (d,), "uniform_decay"),
        "td_w1": ParamDef(ld + (d, LORA_DECAY)),
        "td_w2": ParamDef(ld + (LORA_DECAY, d)),
        "faaaa": ParamDef(ld + (h, k)),
        "wr": ParamDef(ld + (d, d)),
        "wk": ParamDef(ld + (d, d)),
        "wv": ParamDef(ld + (d, d)),
        "wg": ParamDef(ld + (d, d)),
        "wo": ParamDef(ld + (d, d)),
        "lnx_scale": ParamDef(ld + (d,), "ones"),
        "lnx_bias": ParamDef(ld + (d,), "zeros"),
    }
    cm = {
        "maa_k": vec(), "maa_r": vec(),
        "wk": ParamDef(ld + (d, f)),
        "wv": ParamDef(ld + (f, d)),
        "wr": ParamDef(ld + (d, d)),
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
    state: [B,H,K,V] float32 -> (out [B,H,V], new_state).  Written out
    elementwise: exact float32 on any device."""
    rf, kf, vf = r.float(), k.float(), v.float()
    at = kf[..., :, None] * vf[..., None, :]                      # [B,H,K,V]
    full = state + u.float()[None, :, :, None] * at
    out = (rf[..., :, None] * full).sum(-2)
    state = torch.exp(logw.float())[..., None] * state + at
    return out.to(r.dtype), state


def _wkv_kernel(kernels, r, k, v, logw, u, chunk: int):
    """[B,T,H,K] operands -> the [B*H,T,K] kernel layout and back, from a
    zero state.  Returns (out [B,T,H,V], state [B,H,K,V])."""
    B, T, H, K = r.shape
    V = v.shape[-1]

    def flat(x):   # a dense copy: at B = 1 the reshape alone is a strided view
        return x.permute(0, 2, 1, 3).reshape(B * H, T, x.shape[-1]).contiguous()

    out, state = kernels.wkv_chunked(flat(r), flat(k), flat(v), flat(logw),
                                     u.repeat(B, 1), chunk=chunk)
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
    ``state=None`` is the zero state."""
    dtype = x.dtype
    B, T, D = x.shape
    H = D // cfg.wkv_head_dim
    K = cfg.wkv_head_dim
    sx = _token_shift(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(tm, x, sx)

    r = (xr @ tm["wr"].to(dtype)).reshape(B, T, H, K)
    k = (xk @ tm["wk"].to(dtype)).reshape(B, T, H, K)
    v = (xv @ tm["wv"].to(dtype)).reshape(B, T, H, K)
    g = F.silu(xg @ tm["wg"].to(dtype))

    ww = tm["decay"].float() + (
        torch.tanh(xw @ tm["td_w1"].to(dtype)).float() @ tm["td_w2"].float())
    logw = -torch.exp(ww).reshape(B, T, H, K)                      # log decay <= 0

    if T == 1:
        if state is None:
            state = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
        out1, state = wkv_recurrent_step(
            r[:, 0], k[:, 0], v[:, 0], logw[:, 0], tm["faaaa"], state)
        out = out1[:, None]
    else:
        if state is not None and bool(state.any()):
            raise ValueError("time_mix: T > 1 runs the chunked kernel, which "
                             "starts from a zero state")
        out, state = _wkv_kernel(kernels, r, k, v, logw, tm["faaaa"], chunk)
    out = out.reshape(B, T, D)
    out = _group_norm(out, tm["lnx_scale"], tm["lnx_bias"], H)
    out = (out * g) @ tm["wo"].to(dtype)
    return out, x[:, -1, :], state


def channel_mix(cm: Params, x: torch.Tensor, x_prev: torch.Tensor):
    dtype = x.dtype
    sx = _token_shift(x, x_prev) - x
    xk = x + sx * cm["maa_k"].to(dtype)
    xr = x + sx * cm["maa_r"].to(dtype)
    kk = F.relu(xk @ cm["wk"].to(dtype))
    kv = (kk * kk) @ cm["wv"].to(dtype)
    return torch.sigmoid(xr @ cm["wr"].to(dtype)) * kv, x[:, -1, :]


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

    def layer(bp, x, prev_tm, prev_cm, state):
        h = L.norm_apply(cfg, bp["ln1"], x)
        h, s_tm, s = time_mix(cfg, bp["tm"], h, prev_tm, state, cfg.wkv_chunk,
                              kernels)
        x = x + h
        h = L.norm_apply(cfg, bp["ln2"], x)
        h, s_cm = channel_mix(bp["cm"], h, prev_cm)
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
    x = L.norm_apply(cfg, params["ln0"], x)
    x, _, _, _ = _blocks(cfg, params, x, kernels, remat=remat)
    x = L.norm_apply(cfg, params["ln_f"], x)
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
    ``kernels.wkv_chunked``: one launch a layer on the card."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    x = L.norm_apply(cfg, params["ln0"], x)
    T = x.shape[1]
    x, st, sh_tm, sh_cm = _blocks(cfg, params, x, kernels)
    x = L.norm_apply(cfg, params["ln_f"], x)
    # step is filled on the device: a copy from the host's pageable memory
    # (torch.tensor(T, device=...)) cannot be captured into a CUDA graph
    cache = RWKVCache(state=torch.stack(st), shift_tm=torch.stack(sh_tm),
                      shift_cm=torch.stack(sh_cm),
                      step=torch.full((), T, dtype=torch.int32,
                                      device=x.device))
    return x[:, -1, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: RWKVCache,
                batch: Dict[str, Any], *, kernels=ops,
                **_) -> Tuple[torch.Tensor, RWKVCache]:
    """batch["tokens"]: [B, 1] -> (logits [B, padded vocab], cache)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg.compute_dtype)
    x = L.norm_apply(cfg, params["ln0"], x)
    x, st, sh_tm, sh_cm = _blocks(cfg, params, x, kernels, cache)
    x = L.norm_apply(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x)[:, 0, :]
    return logits, RWKVCache(state=torch.stack(st), shift_tm=torch.stack(sh_tm),
                             shift_cm=torch.stack(sh_cm), step=cache.step + 1)


def kernel_launches_per_prefill(cfg: ModelConfig) -> Dict[str, int]:
    """How many times one ``prefill`` or ``forward`` (T > 1) calls each
    kernel; ``decode_step`` calls none."""
    return {"wkv_chunked": cfg.num_layers}
