"""Plain PyTorch versions of the kernels (the allclose targets).

Float32 math with the rounding points of the kernels: ``fused_ibn_ref``
rounds the expanded intermediate T to the input dtype before the second
product, ``attention_ref`` masks with a finite -1e30 so a fully masked
row softmaxes to uniform (``attention_fwd_lse_ref`` also returns each
row's log-sum-exp, and ``attention_bwd_ref`` is the backward by the
reference's formulas), ``matmul_ln_ref`` rounds only its output,
``wkv_ref`` is the per-token recurrence (no chunks) in float32,
``adamw_ref`` one leaf's AdamW step in place, each operation rounded to
float32 where the reference's update rounds it.
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
            window: Optional[int], scale: Optional[float],
            q_offset: int = 0) -> torch.Tensor:
    """The scaled float32 scores [B,H,Sq,Sk], NEG_INF where masked.
    ``q_offset`` is the position of query row 0 less that of key row 0:
    the masks are causal i + q_offset >= j and window i + q_offset - j <
    window."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale_ = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_
    q_pos = torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,H,Sk,D] -> [B,H,Sq,D]; ``q_offset`` as
    ``_scores`` takes it."""
    p = torch.softmax(_scores(q, k, causal, window, scale, q_offset), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None, q_offset: int = 0):
    """``attention_ref`` and each row's float32 log-sum-exp of the scaled,
    masked scores [B,H,Sq] (the reference's ``_flash_fwd`` returns both)."""
    s = _scores(q, k, causal, window, scale, q_offset)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset: int = 0):
    """(dq, dk, dv) in the inputs' types by the reference's ``_flash_bwd``
    formulas on the whole score matrix, in float32: delta = rowsum(dO . O),
    P = exp(S - lse) (S scaled and masked to NEG_INF), dS = P (dP - delta),
    dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO."""
    D = q.shape[3]
    scale_ = scale if scale is not None else D ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    delta = (dof * out.float()).sum(-1)
    p = torch.exp(_scores(q, k, causal, window, scale, q_offset) - lse[..., None])
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
            logw: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Per-token WKV6 recurrence from ``state`` (float32 [BH,K,V]; None is
    the zero state).  r, k, logw: [BH,T,K]; v: [BH,T,V]; u: [BH,K].
    Returns (out [BH,T,V] in r's dtype, final state [BH,K,V] float32).
    Products and sums are written out elementwise, so they are exact
    float32 on any device."""
    BH, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, logw, u))
    S = (torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for t in range(T):
        at = kf[:, t, :, None] * vf[:, t, None, :]            # [BH,K,V]
        outs.append((rf[:, t, :, None] * (S + uf[:, :, None] * at)).sum(1))
        S = torch.exp(wf[:, t])[..., None] * S + at
    return torch.stack(outs, 1).to(r.dtype), S


# rows of a tile of the WKV backward's gradients pass and of an exact
# block of a tile's diagonal block (csrc/wkv_chunked_bwd.cu's TILE, SUB)
WKV_BWD_TILE = 16
WKV_BWD_SUB = 8


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                dstate: Optional[torch.Tensor] = None, *, chunk: int,
                state: Optional[torch.Tensor] = None):
    """The backward of ``wkv_ref`` by the algorithm of
    ``csrc/wkv_chunked_bwd.cu``'s chunk instance, in float32: the states
    entering each chunk of C = min(chunk, T) rows, the reverse pass G_c =
    e^{b_C} G' + (r e^{b_prev})^T dout from G_n = dstate (None: zero), then
    per chunk dr, dk, dv with the products of each WKV_BWD_TILE-row tile
    against the rows before it factored about b_prev of the tile's first row
    (every exponent <= 0), and each tile's diagonal block as two exact
    WKV_BWD_SUB-row blocks and the block below the first factored about
    b_prev of its row WKV_BWD_SUB; dlogw by the suffix identity sum_{t>j} r
    dr' - sum_{s>=j} k dk' + sum_v dS_T S_T (dr', dk' without the u terms),
    the suffix taken within each chunk, then the later chunks' totals and
    the dS_T term added.  ``state`` is the forward's initial state (None:
    zero), which the entering states carry into dr'; the suffix identity
    needs no term of its own for it (S_0 reaches out[t] through the decays
    of the rows before t, as a pair (s, t) does through those between
    them).  r, k, logw: [BH,T,K]; v, dout: [BH,T,V]; u: [BH,K]; dstate,
    state: [BH,K,V].  Returns (dr, dk, dv, dlogw, du), each in the dtype of
    its input, and where ``state`` is given dS0 too: the reverse pass's G
    entering chunk 0, float32."""
    BH, T, K = r.shape
    V = v.shape[-1]
    C, TL, SB = min(chunk, T), WKV_BWD_TILE, WKV_BWD_SUB
    rf, kf, vf, wf, uf, df = (t.float() for t in (r, k, v, logw, u, dout))
    spans = [(c0, min(T, c0 + C)) for c0 in range(0, T, C)]

    def cumsums(c0, c1):   # b and b_prev of a chunk's rows
        b = torch.cumsum(wf[:, c0:c1], 1)
        return b, b - wf[:, c0:c1]

    S = (torch.zeros((BH, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    entering = []
    for c0, c1 in spans:
        b, _ = cumsums(c0, c1)
        entering.append(S)
        S = torch.exp(b[:, -1])[..., None] * S + torch.einsum(
            "btk,btv->bkv", kf[:, c0:c1] * torch.exp(b[:, -1:] - b), vf[:, c0:c1])
    G = dstate.float() if dstate is not None else torch.zeros_like(S)
    leaving = [None] * len(spans)
    for i in reversed(range(len(spans))):
        c0, c1 = spans[i]
        leaving[i] = G
        b, bp = cumsums(c0, c1)
        G = torch.exp(b[:, -1])[..., None] * G + torch.einsum(
            "btk,btv->bkv", rf[:, c0:c1] * torch.exp(bp), df[:, c0:c1])

    drn, dkn, dvs = (torch.zeros_like(t) for t in (rf, kf, vf))
    for (c0, c1), Sc, Gc in zip(spans, entering, leaving):
        b, bp = cumsums(c0, c1)
        bC = b[:, -1:]
        rc, kc, vc, dc = (t[:, c0:c1] for t in (rf, kf, vf, df))
        dr_c = torch.exp(bp) * torch.einsum("btv,bkv->btk", dc, Sc)
        dk_c = torch.exp(bC - b) * torch.einsum("bsv,bkv->bsk", vc, Gc)
        dv_c = torch.einsum("bsk,bkv->bsv", kc * torch.exp(bC - b), Gc)
        for j0 in range(0, c1 - c0, TL):
            J = slice(j0, min(c1 - c0, j0 + TL))
            m = J.stop - j0
            dA = torch.einsum("btv,bsv->bts", dc[:, J], vc[:, J])
            # the diagonal block: two exact SB-row blocks, e^{b_prev[t] -
            # b[s]} for s < t
            for a0 in range(0, m, SB):
                S_ = slice(j0 + a0, j0 + min(m, a0 + SB))
                w = S_.stop - S_.start
                live = torch.tril(torch.ones((w, w), dtype=torch.bool,
                                             device=r.device), diagonal=-1)
                expo = (bp[:, S_, None, :] - b[:, None, S_, :]).masked_fill(
                    ~live[None, :, :, None], float("-inf"))
                E = torch.exp(expo)                                # [BH,t,s,K]
                dAs = dA[:, a0:a0 + w, a0:a0 + w]
                dr_c[:, S_] += torch.einsum("bts,bsk,btsk->btk", dAs, kc[:, S_], E)
                dk_c[:, S_] += torch.einsum("bts,btk,btsk->bsk", dAs, rc[:, S_], E)
                A = torch.einsum("btk,bsk,btsk->bts", rc[:, S_], kc[:, S_], E)
                dv_c[:, S_] += torch.einsum("bts,btv->bsv", A, dc[:, S_])
            # ... and the block below the first, one product about rho8 =
            # b_prev of row SB
            if m > SB:
                lo, hi = slice(j0, j0 + SB), slice(j0 + SB, J.stop)
                rho8 = bp[:, j0 + SB:j0 + SB + 1]
                q8 = rc[:, hi] * torch.exp(bp[:, hi] - rho8)
                kd8 = kc[:, lo] * torch.exp(rho8 - b[:, lo])
                dAl = dA[:, SB:, :SB]
                dr_c[:, hi] += torch.exp(bp[:, hi] - rho8) * torch.einsum(
                    "bts,bsk->btk", dAl, kd8)
                dk_c[:, lo] += torch.exp(rho8 - b[:, lo]) * torch.einsum(
                    "bts,btk->bsk", dAl, q8)
                A = torch.einsum("btk,bsk->bts", q8, kd8)
                dv_c[:, lo] += torch.einsum("bts,btv->bsv", A, dc[:, hi])
            if j0 == 0:
                continue
            # the earlier rows s < j0 against this tile's rows t, about
            # rho = b_prev of the tile's first row
            rho = bp[:, j0:j0 + 1]
            I = slice(0, j0)
            kt = kc[:, I] * torch.exp(rho - b[:, I])
            q = rc[:, J] * torch.exp(bp[:, J] - rho)
            dA = torch.einsum("btv,bsv->bts", dc[:, J], vc[:, I])
            dr_c[:, J] += torch.exp(bp[:, J] - rho) * torch.einsum(
                "bts,bsk->btk", dA, kt)
            A = torch.einsum("btk,bsk->bts", q, kt)
            dv_c[:, I] += torch.einsum("bts,btv->bsv", A, dc[:, J])
            dk_c[:, I] += torch.exp(rho - b[:, I]) * torch.einsum(
                "bts,btk->bsk", dA, q)
        drn[:, c0:c1], dkn[:, c0:c1], dvs[:, c0:c1] = dr_c, dk_c, dv_c

    bonus = (df * vf).sum(-1, keepdim=True)                       # dout[t].v[t]
    dr = drn + uf[:, None] * kf * bonus
    dk = dkn + uf[:, None] * rf * bonus
    dv = dvs + (rf * uf[:, None] * kf).sum(-1, keepdim=True) * df
    du = (rf * kf * bonus).sum(1)
    xr = rf * drn
    x = xr - kf * dkn
    dlogw = torch.empty_like(x)
    carry = (dstate.float() * S).sum(-1) if dstate is not None else \
        torch.zeros_like(uf)
    for c0, c1 in reversed(spans):   # the suffix within the chunk, then the later ones
        suffix = torch.flip(torch.cumsum(torch.flip(x[:, c0:c1], (1,)), 1), (1,))
        dlogw[:, c0:c1] = (suffix - xr[:, c0:c1]) + carry[:, None]
        carry = carry + suffix[:, 0]
    grads = (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
             dlogw.to(logw.dtype), du.to(u.dtype))
    return grads if state is None else (*grads, G)


def adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
              lr, bc1, bc2, scale=None, b1: float = 0.9, b2: float = 0.95,
              eps: float = 1e-8, weight_decay: float = 0.1) -> None:
    """One AdamW step of the leaf ``p``, written into ``p``, ``m`` and ``v``
    (``g`` is read only): the reference's ``upd`` (``repro/optim/adamw.py``)
    on ``g * scale`` (the clip's factor, rounded first; None: no clip), one
    PyTorch operation a step of it, as the port's update ran before the
    kernel."""
    g = g.float()
    if scale is not None:
        g = g * scale.to(g.dtype)
    m.mul_(b1).add_(g * (1.0 - b1))
    v.mul_(b2).add_(torch.square(g).mul_(1.0 - b2))
    vhat = v / bc2
    step = (m / bc1).div_(vhat.sqrt_().add_(eps)).add_(weight_decay * p)
    p.sub_(step.mul_(lr).to(p.dtype))


# The plain versions under the names and signatures of ``ops``: a model
# built with ``kernels=ref.PLAIN`` runs the same composition without any
# kernel, on any device.
PLAIN = types.SimpleNamespace(
    fused_ibn=lambda x, w1, w2, wg=None, *, activation="gelu", **_blocks:
        fused_ibn_ref(x, w1, w2, wg, activation=activation),
    flash_attention=lambda q, k, v, *, causal=True, window=None, scale=None,
        q_offset=0, **_blocks: attention_ref(q, k, v, causal=causal, window=window,
                                             scale=scale, q_offset=q_offset),
    depthwise_conv2d=lambda x, w, b, **_blocks: depthwise_conv2d_ref(x, w, b),
    matmul_ln=lambda x, w, b, gamma, beta, *, eps=1e-6, **_blocks:
        matmul_ln_ref(x, w, b, gamma, beta, eps=eps),
    wkv_chunked=lambda r, k, v, logw, u, *, chunk=64, state=None:
        wkv_ref(r, k, v, logw, u, state),
    adamw_update=adamw_ref,
)
