"""Plain PyTorch versions of the kernels (the allclose targets).

Float32 math with the rounding points of the kernels: ``fused_ibn_ref``
rounds the expanded intermediate T to the input dtype before the second
product, ``attention_ref`` masks with a finite -1e30 so a fully masked
row softmaxes to uniform (``attention_fwd_lse_ref`` also returns each
row's log-sum-exp, and ``attention_bwd_ref`` is the backward by the
reference's formulas), ``matmul_ln_ref`` rounds only its output,
``wkv_ref`` is the per-token recurrence (no chunks) in float32.
They run on any device; ``ops`` sends only CPU tensors here.
"""
from __future__ import annotations

import types
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu2":
        r = torch.clamp_min(x, 0.0)
        return r * r
    raise ValueError(name)


def fused_ibn_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  wg: Optional[torch.Tensor] = None, *,
                  activation: str = "gelu") -> torch.Tensor:
    """act(x @ w1) @ w2, or (act(x @ wg) * (x @ w1)) @ w2; x: [..., D]."""
    xf = x.float()
    up = xf @ w1.float()
    if wg is not None:
        t = _act(activation, xf @ wg.float()) * up
    else:
        t = _act(activation, up)
    out = t.to(x.dtype).float() @ w2.float()
    return out.to(x.dtype)


def matmul_ln_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """LN(x @ w + b) * gamma + beta over the last axis; x: [M, K], w:
    [K, N].  The biased variance is the mean of squared deviations."""
    y = x.float() @ w.float() + b.float()
    mean = y.mean(-1, keepdim=True)
    var = torch.square(y - mean).mean(-1, keepdim=True)
    yn = (y - mean) * torch.rsqrt(var + eps)
    return (yn * gamma.float() + beta.float()).to(x.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: Optional[float]) -> torch.Tensor:
    """The scaled float32 scores [B,H,Sq,Sk], NEG_INF where masked."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale_ = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,H,Sk,D] -> [B,H,Sq,D]."""
    p = torch.softmax(_scores(q, k, causal, window, scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None):
    """``attention_ref`` and each row's float32 log-sum-exp of the scaled,
    masked scores [B,H,Sq] (the reference's ``_flash_fwd`` returns both)."""
    s = _scores(q, k, causal, window, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None):
    """(dq, dk, dv) in the inputs' types by the reference's ``_flash_bwd``
    formulas on the whole score matrix, in float32: delta = rowsum(dO . O),
    P = exp(S - lse) (S scaled and masked to NEG_INF), dS = P (dP - delta),
    dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO."""
    D = q.shape[3]
    scale_ = scale if scale is not None else D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    delta = (dof * out.float()).sum(-1)
    p = torch.exp(_scores(q, k, causal, window, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale_
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale_
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def depthwise_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """x: [B,H,W,C]; w: [fy,fx,C]; b: [C] -> [B,H,W,C], SAME padding
    ((k-1)//2 before, k//2 after).  A sum of shifted slices, tap by tap:
    exact float32 on any device, where a library convolution may not be."""
    B, H, W, C = x.shape
    fy, fx, _ = w.shape
    py0, py1 = (fy - 1) // 2, fy // 2
    px0, px1 = (fx - 1) // 2, fx // 2
    xp = F.pad(x.float(), (0, 0, px0, px1, py0, py1))
    wf = w.float()
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dy in range(fy):
        for dx in range(fx):
            acc += xp[:, dy:dy + H, dx:dx + W, :] * wf[dy, dx]
    return (acc + b.float()).to(x.dtype)


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor):
    """Per-token WKV6 recurrence from a zero state.  r, k, logw: [BH,T,K];
    v: [BH,T,V]; u: [BH,K].  Returns (out [BH,T,V] in r's dtype, final
    state [BH,K,V] float32).  Products and sums are written out
    elementwise, so they are exact float32 on any device."""
    BH, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, logw, u))
    S = torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(T):
        at = kf[:, t, :, None] * vf[:, t, None, :]            # [BH,K,V]
        outs.append((rf[:, t, :, None] * (S + uf[:, :, None] * at)).sum(1))
        S = torch.exp(wf[:, t])[..., None] * S + at
    return torch.stack(outs, 1).to(r.dtype), S


# The plain versions under the names and signatures of ``ops``: a model
# built with ``kernels=ref.PLAIN`` runs the same composition without any
# kernel, on any device.
PLAIN = types.SimpleNamespace(
    fused_ibn=lambda x, w1, w2, wg=None, *, activation="gelu", **_blocks:
        fused_ibn_ref(x, w1, w2, wg, activation=activation),
    flash_attention=lambda q, k, v, *, causal=True, window=None, scale=None,
        **_blocks: attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale),
    depthwise_conv2d=lambda x, w, b, **_blocks: depthwise_conv2d_ref(x, w, b),
    matmul_ln=lambda x, w, b, gamma, beta, *, eps=1e-6, **_blocks:
        matmul_ln_ref(x, w, b, gamma, beta, eps=eps),
    wkv_chunked=lambda r, k, v, logw, u, *, chunk=64: wkv_ref(r, k, v, logw, u),
)
