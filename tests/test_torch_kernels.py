"""The port's kernel modules against the JAX package, on the CPU.

The same numpy arrays, made from a seed, go through ``repro.kernels.ops``
(the Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
them) and through ``repro_torch.kernels.ops`` (on a CPU tensor: the plain
PyTorch version that the CUDA kernel is held against on the card).
Tolerances are the JAX tests' own: 3e-5 for float32 (2e-4 attention),
2e-2 for bfloat16 — float32 sums taken in another order, bfloat16
rounding of the result.
"""
import importlib.util
import math
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import depthwise_conv as t_dw
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import fused_ibn as t_ibn
from repro_torch.kernels import matmul_ln as t_mln
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_chunk as t_wkv
from repro_torch.core.workload import Layer
from repro_torch.search import lower as t_lower


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# fused inverted bottleneck
# ---------------------------------------------------------------------------


def _ibn_inputs(seed, m, d, f, do, gated):
    r = _rng(seed)
    x = r.standard_normal((m, d)).astype(np.float32)
    w1 = (r.standard_normal((d, f)) * 0.1).astype(np.float32)
    w2 = (r.standard_normal((f, do)) * 0.1).astype(np.float32)
    wg = (r.standard_normal((d, f)) * 0.1).astype(np.float32) if gated else None
    return x, w1, w2, wg


@pytest.mark.parametrize("m,d,f,do,gated,act,bm,bf", [
    (64, 32, 128, 32, False, "gelu", 32, 64),
    (64, 32, 128, 32, True, "silu", 32, 64),
    (64, 32, 128, 32, False, "relu2", 32, 64),
    (48, 16, 96, 24, True, "gelu", 16, 32),
    (197, 48, 160, 48, False, "gelu", 64, 64),     # ragged m and f
    (197, 48, 160, 48, True, "silu", 64, 64),
    (64, 17, 64, 16, False, "gelu", 32, 32),       # folded-bias odd D
])
def test_fused_ibn_matches_jax(m, d, f, do, gated, act, bm, bf):
    x, w1, w2, wg = _ibn_inputs(1, m, d, f, do, gated)
    want = jops.fused_ibn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                          None if wg is None else jnp.asarray(wg),
                          activation=act, block_m=bm, block_f=bf)
    got = tops.fused_ibn(_t(x), _t(w1), _t(w2),
                         None if wg is None else _t(wg), activation=act,
                         block_m=bm, block_f=bf)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, do)
    _close(got.numpy(), want, 3e-5)


def test_fused_ibn_folded_bias_equals_biased_mlp():
    """x with a column of ones against w1 with the bias as its last row is
    gelu(x @ w1 + b1) @ w2: the fold the model uses, on both packages."""
    r = _rng(2)
    x = r.standard_normal((40, 24)).astype(np.float32)
    w1 = (r.standard_normal((24, 96)) * 0.1).astype(np.float32)
    b1 = (r.standard_normal((96,)) * 0.1).astype(np.float32)
    w2 = (r.standard_normal((96, 24)) * 0.1).astype(np.float32)
    xa = np.concatenate([x, np.ones((40, 1), np.float32)], -1)
    wa = np.concatenate([w1, b1[None]], 0)
    want = jops.fused_ibn(jnp.asarray(xa), jnp.asarray(wa), jnp.asarray(w2),
                          block_m=32, block_f=32)
    got = tops.fused_ibn(_t(xa), _t(wa), _t(w2))
    direct = torch.nn.functional.gelu(_t(x) @ _t(w1) + _t(b1),
                                      approximate="tanh") @ _t(w2)
    _close(got.numpy(), want, 3e-5)
    _close(got.numpy(), direct.numpy(), 3e-5)


@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu"),
                                       (False, "relu2")])
def test_fused_ibn_bf16_ref_matches_jax_ref(gated, act):
    """The rounding point of T (to the input dtype, before the second
    product) is the same in the two plain versions."""
    x, w1, w2, wg = _ibn_inputs(3, 100, 48, 96, 48, gated)
    jb = [None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
          for a in (x, w1, w2, wg)]
    tb = [None if a is None else _t(a).to(torch.bfloat16)
          for a in (x, w1, w2, wg)]
    want = jref.fused_ibn_ref(*jb, activation=act)
    got = tref.fused_ibn_ref(*tb, activation=act)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


def test_fused_ibn_rounds_t_to_the_input_dtype():
    """relu2(1 + 2^-7) = 1.01568604 rounds to 1 + 2^-6 in bfloat16, so
    against w2 = [1 + 2^-6, -1] the two terms cancel exactly; without the
    rounding of T the result would be -6.1e-5."""
    x = np.array([[1.0]], np.float32)
    w1 = np.array([[1.0, 1.0078125]], np.float32)
    w2 = np.array([[1.015625], [-1.0]], np.float32)
    want = jref.fused_ibn_ref(*[jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (x, w1, w2)], activation="relu2")
    got = tref.fused_ibn_ref(*[_t(a).to(torch.bfloat16) for a in (x, w1, w2)],
                             activation="relu2")
    assert float(want[0, 0]) == 0.0 and got.float().item() == 0.0
    exact = tref.fused_ibn_ref(_t(x), _t(w1), _t(w2), activation="relu2")
    assert abs(exact.item() + 6.1035e-5) < 1e-7


def test_fused_ibn_leading_dims():
    x, w1, w2, _ = _ibn_inputs(4, 60, 16, 64, 8, False)
    flat = tops.fused_ibn(_t(x), _t(w1), _t(w2))
    lead = tops.fused_ibn(_t(x).reshape(3, 4, 5, 16), _t(w1), _t(w2))
    assert tuple(lead.shape) == (3, 4, 5, 8)
    np.testing.assert_array_equal(lead.reshape(60, 8).numpy(), flat.numpy())


# the fused_ibn kernel's own arithmetic, on the CPU: how plan() splits F
# over the grid, the split sums, and the 3xTF32 products


def _cdiv(a, b):
    return -(-a // b)


_PLAN_SHAPES = [
    (65536, 192, 48), (16384, 384, 96), (4096, 640, 160), (1024, 1216, 304),
    (4096, 192, 48), (1024, 384, 96), (256, 640, 160), (64, 1216, 304),
    (1, 1216, 304), (197, 160, 48), (100, 300, 400), (2048, 7168, 2048),
    (64, 1000, 48)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("m,f,do", _PLAN_SHAPES)
def test_fused_ibn_plan_splits_f_into_nonempty_shares(m, f, do, sms):
    """S never exceeds the F tiles; the shares are contiguous, none is
    empty, their sizes differ by at most one and together they walk every
    F tile once; the workspace is S*M*Do float32 only where S > 1."""
    p = t_ibn.plan(m, f, do, sms)
    s, nf = p["splits"], p["f_tiles"]
    assert nf == _cdiv(f, t_ibn.BLOCKS["block_f"])
    assert 1 <= s <= nf
    shares = [t_ibn.share(z, s, nf) for z in range(s)]
    assert all(len(sh) >= 1 for sh in shares)
    assert max(map(len, shares)) - min(map(len, shares)) <= 1
    assert [t for sh in shares for t in sh] == list(range(nf))
    assert p["workspace_bytes"] == (s * m * do * 4 if s > 1 else 0)
    assert p["block_do"] in t_ibn.BLOCK_DO
    assert p["grid"] == (_cdiv(m, t_ibn.BLOCKS["block_m"]),
                         _cdiv(do, p["block_do"]), s)
    assert p["ctas"] == p["grid"][0] * p["grid"][1] * p["grid"][2]


@pytest.mark.parametrize("m,f,do", [(4096, 640, 160), (1024, 1216, 304)],
                         ids=["stage3_b16", "stage4_b16"])
def test_fused_ibn_plan_fills_the_card_at_stages_3_4(m, f, do):
    """EdgeNeXt-S stages 3-4 at B = 16 have 64 and 16 row tiles; split
    over F they reach about two blocks a SM of a 132-SM card."""
    p = t_ibn.plan(m, f, do, 132)
    assert p["splits"] > 1
    assert p["ctas"] >= 0.9 * t_ibn.BLOCKS_PER_SM * 132


def _split_f_sum(x, w1, w2, wg, act, splits):
    """The kernel's split-F arithmetic in plain torch: per split, each of
    its F tiles zero-filled to 64 columns, activated, masked past F,
    rounded to x's type and contracted into a float32 partial; the
    partials summed in the order s = 0..S-1."""
    d, f = w1.shape
    bf = t_ibn.BLOCKS["block_f"]
    nf = _cdiv(f, bf)
    xf = x.float()
    parts = []
    for z in range(splits):
        acc = torch.zeros((x.shape[0], w2.shape[1]))
        for t in t_ibn.share(z, splits, nf):
            n = min(bf, f - t * bf)
            cols = slice(t * bf, t * bf + n)
            w1t = torch.zeros((d, bf))
            w1t[:, :n] = w1[:, cols].float()
            up = xf @ w1t
            if wg is None:
                h = tref._act(act, up)
            else:
                wgt = torch.zeros((d, bf))
                wgt[:, :n] = wg[:, cols].float()
                h = tref._act(act, xf @ wgt) * up
            h[:, n:] = 0.0
            w2t = torch.zeros((bf, w2.shape[1]))
            w2t[:n] = w2[cols].float()
            acc += h.to(x.dtype).float() @ w2t
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.to(x.dtype)


@pytest.mark.parametrize("m,d,f,do,gated,act", [
    (64, 49, 1000, 48, False, "gelu"),      # 16 shares, ragged last tile
    (197, 48, 160, 48, True, "silu"),       # 3 shares, ragged last tile
    (33, 17, 330, 20, False, "relu2"),
    (1, 305, 1216, 304, False, "gelu"),     # M = 1, stage-4 widths
])
def test_fused_ibn_split_f_sum_matches_ref(m, d, f, do, gated, act):
    x, w1, w2, wg = _ibn_inputs(31, m, d, f, do, gated)
    splits = t_ibn.plan(m, f, do, 132)["splits"]
    assert splits > 1
    args = (_t(x), _t(w1), _t(w2), None if wg is None else _t(wg))
    got = _split_f_sum(*args, act, splits)
    want = tref.fused_ibn_ref(*args, activation=act)
    _close(got.numpy(), want.numpy(), 3e-5)


def _tf32(a):
    """Round to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``wmma::__float_to_tf32`` does."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(a):
    """The top 19 bits of a float32: what the tensor cores read of a TF32
    operand."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_mm(a, b, terms):
    """a @ b on TF32 tensor cores: one term (big . big) or three (each
    operand split into big = tf32(a) and small = a - big, which the tensor
    cores truncate; small . small dropped), as csrc/fused_ibn.cu does."""
    ab, bb = _tf32(a), _tf32(b)
    if terms == 1:
        return ab @ bb
    return (ab @ _tf32_trunc(b - bb) + _tf32_trunc(a - ab) @ bb) + ab @ bb


@pytest.mark.parametrize("m,d,f,do,scale", [
    (64, 305, 1216, 304, (0.1, 0.1)),                  # EdgeNeXt-S stage 4
    (64, 2048, 7168, 2048, (2048 ** -0.5, 7168 ** -0.5)),  # RWKV-6 lowered
], ids=["edgenext_stage4", "rwkv6"])
def test_fused_ibn_3xtf32_holds_the_float32_tolerance(m, d, f, do, scale):
    """3xTF32 products stay within 3e-5 (1 + |b|) of the float32 plain
    version at the widest fused_ibn shapes; one TF32 term does not."""
    r = _rng(32)
    x = _t(r.standard_normal((m, d)).astype(np.float32))
    w1 = _t((r.standard_normal((d, f)) * scale[0]).astype(np.float32))
    w2 = _t((r.standard_normal((f, do)) * scale[1]).astype(np.float32))
    want = tref.fused_ibn_ref(x, w1, w2, activation="gelu")
    err = {terms: float(((_tf32_mm(tref._act("gelu", _tf32_mm(x, w1, terms)),
                                   w2, terms) - want).abs()
                         / (1 + want.abs())).max())
           for terms in (1, 3)}
    assert err[3] <= 3e-5 < err[1]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _qkv(seed, b, h, sq, sk, d, unit=False):
    r = _rng(seed)
    q = r.standard_normal((b, h, sq, d)).astype(np.float32)
    k = r.standard_normal((b, h, sk, d)).astype(np.float32)
    v = r.standard_normal((b, h, sk, d)).astype(np.float32)
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        k /= np.linalg.norm(k, axis=-1, keepdims=True)
    return q, k, v


@pytest.mark.parametrize("sq,sk,d,causal,window,scale,bq,bk,unit", [
    (64, 64, 16, True, None, None, 16, 16, False),
    (64, 128, 16, True, 24, None, 16, 64, False),
    (12, 12, 64, False, None, 1.0, 512, 512, True),   # the XCA shape
    (37, 50, 16, False, None, None, 16, 16, False),   # ragged Sq and Sk
    (50, 50, 8, True, 7, 0.5, 16, 32, False),
])
def test_flash_attention_matches_jax(sq, sk, d, causal, window, scale, bq, bk,
                                     unit):
    q, k, v = _qkv(5, 2, 2, sq, sk, d, unit)
    kw = dict(causal=causal, window=window, scale=scale)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=bq, block_k=bk, **kw)
    got = tops.flash_attention(_t(q), _t(k), _t(v), block_q=bq, block_k=bk,
                               **kw)
    assert tuple(got.shape) == (2, 2, sq, d)
    _close(got.numpy(), want, 2e-4)


def test_attention_ref_fully_masked_rows_are_uniform():
    """NEG_INF is finite: a row with every key masked averages v, in both
    plain versions (causal + window with Sq > Sk leaves such rows)."""
    q, k, v = _qkv(6, 1, 1, 30, 10, 8)
    kw = dict(causal=True, window=4)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    got = tref.attention_ref(_t(q), _t(k), _t(v), **kw)
    _close(got.numpy(), want, 2e-4)
    _close(got[0, 0, 20].numpy(), v[0, 0].mean(0), 2e-4)


def test_attention_ref_bf16_matches_jax_ref():
    q, k, v = _qkv(7, 1, 2, 64, 64, 32)
    want = jref.attention_ref(*[jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)])
    got = tref.attention_ref(*[_t(a).to(torch.bfloat16) for a in (q, k, v)])
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2e-2)


# the flash attention kernel's whole-row regime, on the CPU: how plan()
# splits D over a cluster and the query rows over the grid, and its
# arithmetic (partial scores of each slice summed in rank order, an exact
# softmax, 3xTF32 products in 32-deep slabs)

# (BH, Sq, Sk, D): the 19 distinct lowered launches (EdgeNeXt-S's are its
# B = 1 XCA shapes), then the XCA shapes of a B = 16 EdgeNeXt-S forward
_FA_LOWERED = [
    (4, 24, 24, 1024), (4, 40, 40, 256), (4, 76, 76, 64), (16, 24, 24, 1024),
    (16, 40, 40, 256), (16, 76, 76, 64), (2, 12, 12, 16), (2, 16, 16, 4),
    (2, 24, 24, 1), (3, 196, 196, 64), (16, 256, 256, 36), (16, 64, 64, 48),
    (16, 16, 16, 60), (64, 256, 256, 36), (64, 64, 64, 48), (64, 16, 16, 60),
    (8, 64, 64, 64), (32, 64, 64, 64), (10, 448, 448, 256)]
_FA_XCA_B16 = [(64, 24, 24, 1024), (64, 40, 40, 256), (64, 76, 76, 64)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,sq,sk,d", _FA_LOWERED + _FA_XCA_B16)
def test_flash_attention_plan_splits_d_and_rows(bh, sq, sk, d, itemsize):
    """Whole rows where Sk <= S_MAX: the cluster size is one of 1, 2, 4, 8
    and at most the column units of D; the slices cover D contiguously in
    whole units (the last clipped to D), none empty, differing by one
    unit at most; the row blocks cover Sq in whole 16-row tiles, differing
    by one tile at most; the block fits its shared memory.  Longer rows
    take the online regime."""
    p = t_fa.plan(bh, sq, sk, d, 132, itemsize=itemsize)
    if sk > t_fa.S_MAX:
        assert p["regime"] == "online"
        assert p["ctas"] == bh * p["row_splits"] * p["splits"]
        assert p["row_splits"] == _cdiv(sq, t_fa.BLOCKS["block_q"])
        return
    assert p["regime"] == "rows"
    u = t_fa.unit(itemsize)
    s, r, sl, rows = p["splits"], p["row_splits"], p["slices"], p["rows"]
    assert s in t_fa.CLUSTER and s <= 8 and s <= _cdiv(d, u)
    assert len(sl) == s and sl[0][0] == 0 and sl[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    widths = [hi - lo for lo, hi in sl]
    assert min(widths) > 0 and all(w % u == 0 for w in widths[:-1])
    assert max(_cdiv(w, u) for w in widths) - min(_cdiv(w, u)
                                                  for w in widths) <= 1
    assert len(rows) == r and rows[0][0] == 0 and rows[-1][1] == sq
    assert all(a[1] == b[0] and a[1] % 16 == 0 for a, b in zip(rows, rows[1:]))
    tiles = [_cdiv(hi - lo, 16) for lo, hi in rows]
    assert min(tiles) > 0 and max(tiles) - min(tiles) <= 1
    assert p["grid"] == (s * bh, r) and p["ctas"] == s * r * bh
    assert t_fa.smem_bytes(16 * max(tiles), sk, u * max(_cdiv(w, u)
                                                        for w in widths),
                           itemsize) <= t_fa.SMEM_BYTES


@pytest.mark.parametrize("sk,d,regime", [
    (128, 64, "rows"), (129, 64, "online"), (128, 1024, "rows"),
    (1, 1, "rows"), (128, 16384, "online")])
def test_flash_attention_plan_switches_regime_at_s_max(sk, d, regime):
    """Whole rows up to S_MAX keys, where the slices fit shared memory;
    the online regime past it, and for a D too wide for eight slices."""
    assert t_fa.plan(2, 128, sk, d, 132)["regime"] == regime


@pytest.mark.parametrize("bh,sq,d,splits,row_splits", [
    (64, 24, 1024, 2, 1), (64, 40, 256, 2, 2), (64, 76, 64, 1, 4),
    (4, 24, 1024, 8, 2), (4, 40, 256, 8, 3), (4, 76, 64, 8, 5)],
    ids=["b16_stage2", "b16_stage3", "b16_stage4", "b1_stage2", "b1_stage3",
         "b1_stage4"])
def test_flash_attention_plan_at_the_xca_shapes(bh, sq, d, splits,
                                                row_splits):
    """The splits ``plan`` gives the XCA shapes on a 132-SM card, the
    fastest of every split ``python -m repro_torch.profile_flash_attention``
    timed on the H100 or within 10 % of it: at B = 16 one wave that fills
    the card with a cluster of at most 2 (D over 2 blocks at 1024 and 256
    columns, none at 64) and the most of the card's block slots (the
    query rows in 2 and 4 blocks at 40 and 76 rows); at B = 1, whose grid
    cannot fill the card, the most blocks (D over 8, a 16-row tile
    each)."""
    p = t_fa.plan(bh, sq, sq, d, 132)
    assert (p["regime"], p["splits"], p["row_splits"]) == ("rows", splits,
                                                           row_splits)
    smem = t_fa.smem_bytes(16 * _cdiv(_cdiv(sq, 16), row_splits), sq,
                           8 * _cdiv(_cdiv(d, 8), splits))
    assert p["ctas"] <= t_fa.blocks_per_sm(smem) * 132    # one wave


def _slab_bmm(a, b, terms, slab=32):
    """a @ b (batched) as the kernel takes it: each slab of the reduction
    on the tensor cores (``_tf32_mm``) summed from zero, the slabs added
    in float32."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], slab):
        acc = acc + _tf32_mm(a[..., k0:k0 + slab], b[..., k0:k0 + slab, :],
                             terms)
    return acc


def _rows_emulated(q, k, v, *, causal, window, scale, splits, terms):
    """The whole-row kernel's arithmetic on [BH, S, D] float32 tensors: the
    partial scores of each slice of D, summed in rank order, scaled and
    masked; an exact softmax over whole rows; P V / l."""
    sq, sk = q.shape[1], k.shape[1]
    s = None
    for lo, hi in t_fa.slices(q.shape[-1], splits):
        part = _slab_bmm(q[..., lo:hi], k[..., lo:hi].transpose(1, 2), terms)
        s = part if s is None else s + part
    qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s * scale, torch.full_like(s, tref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _slab_bmm(p, v, terms) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("sq,sk,d,causal,window,scale,unit", [
    (24, 24, 1024, False, None, 1.0, True),    # the XCA shapes
    (40, 40, 256, False, None, 1.0, True),
    (76, 76, 64, False, None, 1.0, True),
    (64, 64, 16, True, None, None, False),
    (64, 128, 16, True, 24, None, False),
    (50, 50, 24, True, 7, 0.5, False),
    (30, 10, 24, True, 4, None, False),         # rows 14.. see no key
    (37, 50, 70, True, 9, None, False),         # D = 70: a ragged last unit
], ids=["xca_24", "xca_40", "xca_76", "causal", "window", "window_scale",
        "masked_rows", "ragged_d"])
def test_flash_attention_whole_rows_match_jax(sq, sk, d, causal, window,
                                              scale, unit):
    """The whole-row algorithm, with D over the largest cluster its column
    units allow (2-8 blocks; 9 units over 8 at D = 70), against the JAX
    Pallas kernel in interpret mode on the same inputs within the
    attention tolerance, 2e-4."""
    q, k, v = _qkv(41, 1, 2, sq, sk, d, unit)
    assert t_fa.plan(2, sq, sk, d, 132)["regime"] == "rows"
    splits = max(c for c in t_fa.CLUSTER if c <= _cdiv(d, 8))
    assert splits > 1
    kw = dict(causal=causal, window=window)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), scale=scale,
                                **t_fa.BLOCKS, **kw)
    got = _rows_emulated(*(_t(a)[0] for a in (q, k, v)), splits=splits,
                         terms=3, scale=d ** -0.5 if scale is None else scale,
                         **kw)
    _close(got.numpy(), np.asarray(want)[0], 2e-4)


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (64, 24, 24, 1024, False), (64, 40, 40, 256, False),
    (64, 76, 76, 64, False), (8, 128, 128, 64, True)],
    ids=["xca_b16_24", "xca_b16_40", "xca_b16_76", "causal_128"])
def test_flash_attention_3xtf32_holds_the_attention_tolerance(bh, sq, sk, d,
                                                              causal):
    """3xTF32 holds 2e-4 (1 + |b|) against the float32 plain version at
    the B = 16 XCA shapes (unit rows, scale 1) and at a causal 128-key
    shape (N(0, 1) rows, scale D^-0.5), with ``plan``'s splits.  One TF32
    term breaks it at the widest XCA shape (D = 1024, where v's rounding
    in P V dominates) and at the causal shape; at the narrower XCA shapes
    it stays within 1.5x of the limit."""
    r = _rng(42)
    q, k, v = (_t(r.standard_normal((bh, s, d)).astype(np.float32))
               for s in (sq, sk, sk))
    if causal:
        scale = d ** -0.5
    else:
        q, k, scale = q / q.norm(dim=-1, keepdim=True), \
            k / k.norm(dim=-1, keepdim=True), 1.0
    want = tref.attention_ref(q[None], k[None], v[None], causal=causal,
                              scale=scale)[0]
    splits = t_fa.plan(bh, sq, sk, d, 132)["splits"]
    err = {terms: float(((_rows_emulated(q, k, v, causal=causal, window=None,
                                         scale=scale, splits=splits,
                                         terms=terms) - want).abs()
                         / (1 + want.abs())).max())
           for terms in (1, 3)}
    assert err[3] <= 2e-4
    if d == 1024 or causal:
        assert err[1] > 2e-4


# ---------------------------------------------------------------------------
# depthwise conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,c,k,bc", [(12, 12, 24, 3, 8), (10, 14, 52, 5, 16),
                                        (8, 8, 16, 7, 16), (9, 7, 52, 3, 128)])
def test_depthwise_conv_matches_jax(h, w, c, k, bc):
    r = _rng(8)
    x = r.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (r.standard_normal((k, k, c)) * 0.2).astype(np.float32)
    b = (r.standard_normal((c,)) * 0.1).astype(np.float32)
    want = jops.depthwise_conv2d(jnp.asarray(x), jnp.asarray(wt),
                                 jnp.asarray(b), block_c=bc)
    got = tops.depthwise_conv2d(_t(x), _t(wt), _t(b), block_c=bc)
    assert tuple(got.shape) == (2, h, w, c)
    _close(got.numpy(), want, 3e-5)


def test_depthwise_conv_even_kernel_pads_as_jax():
    """SAME with an even kernel pads (k-1)//2 before and k//2 after."""
    r = _rng(9)
    x = r.standard_normal((1, 6, 7, 5)).astype(np.float32)
    wt = r.standard_normal((4, 2, 5)).astype(np.float32)
    b = r.standard_normal((5,)).astype(np.float32)
    want = jref.depthwise_conv2d_ref(jnp.asarray(x), jnp.asarray(wt),
                                     jnp.asarray(b))
    _close(tref.depthwise_conv2d_ref(_t(x), _t(wt), _t(b)).numpy(), want, 3e-5)


def test_depthwise_conv_channel_slice_input():
    """A channel slice of a wider activation (what the SDTA cascade hands
    over) gives what its dense copy gives."""
    r = _rng(10)
    wide = _t(r.standard_normal((2, 8, 8, 40)).astype(np.float32))
    wt = _t(r.standard_normal((3, 3, 13)).astype(np.float32))
    b = _t(r.standard_normal((13,)).astype(np.float32))
    sl = wide[..., 13:26]
    assert not sl.is_contiguous()
    np.testing.assert_array_equal(
        tops.depthwise_conv2d(sl, wt, b).numpy(),
        tops.depthwise_conv2d(sl.contiguous(), wt, b).numpy())


# the depthwise kernel's own arithmetic, on the CPU: how plan() tiles the
# image and the channels, and each block's halo tile zero-filled outside
# the image with every output's taps summed in the order dy, then dx


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dw_path_shapes():
    """(B, H, W, C, k, slice) of every depthwise launch of an EdgeNeXt-S
    forward at batch 16 and at batch 1, from ``chip_smoke.path_shapes``."""
    smoke = _chip_smoke()
    return [args for batch in (16, 1)
            for args, _ in smoke.merge_counts(
                smoke.path_shapes(smoke.CONFIG, batch)[1])]


def _dw_align(C, slice_of, itemsize):
    """``alignment`` of a dense x, or of a slice at channel ``start`` of a
    ``total``-wide x whose base is 256-byte aligned (as the allocator's)."""
    total, start = slice_of or (C, 0)
    return math.gcd(start * itemsize, total * itemsize, 16)


def _dw_emulated(x, w, b, p):
    """The kernel's arithmetic on float32 [B, H, W, C]: every block of the
    plan ``p`` (th x tw pixels x cb channels of one image) stages its
    (th + fy - 1) x (tw + fx - 1) halo tile, zero outside the image, and
    sums each output's taps from zero in the order dy, then dx, then adds
    the bias.  Which thread owns an output (its strip) changes no sum."""
    B, H, W, C = x.shape
    fy, fx, _ = w.shape
    th, tw, cb = p["th"], p["tw"], p["cb"]
    out = torch.full((B, H, W, C), float("nan"))
    for bi in range(B):
        for c0 in range(0, C, cb):
            c1 = min(C, c0 + cb)
            for oy0 in range(0, H, th):
                for ox0 in range(0, W, tw):
                    iy0, ix0 = oy0 - (fy - 1) // 2, ox0 - (fx - 1) // 2
                    halo = torch.zeros(th + fy - 1, tw + fx - 1, c1 - c0)
                    y0, y1 = max(iy0, 0), min(iy0 + th + fy - 1, H)
                    x0, x1 = max(ix0, 0), min(ix0 + tw + fx - 1, W)
                    halo[y0 - iy0:y1 - iy0, x0 - ix0:x1 - ix0] = \
                        x[bi, y0:y1, x0:x1, c0:c1]
                    acc = torch.zeros(th, tw, c1 - c0)
                    for dy in range(fy):
                        for dx in range(fx):
                            acc = acc + halo[dy:dy + th, dx:dx + tw] \
                                * w[dy, dx, c0:c1]
                    acc = acc + b[c0:c1]
                    out[bi, oy0:oy0 + th, ox0:ox0 + tw, c0:c1] = \
                        acc[:min(th, H - oy0), :min(tw, W - ox0)]
    return out


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,k,sl", _dw_path_shapes())
def test_depthwise_plan_fills_the_card_within_budget(B, H, W, C, k, sl,
                                                     itemsize):
    """At every EdgeNeXt-S depthwise shape of a batch-16 and a batch-1
    forward, on a 132-SM card: blocks of at least a warp; where such
    blocks can cover every SM, the grid does (every batch-16 shape, and
    the batch-1 stage-1 and stage-2 convolutions), else the tile of least
    modelled time; a block's shared memory within the opt-in limit and
    its threads within MAX_THREADS; the tile no wider or taller than the
    image (rounded to whole strips); the last channel chunk at least half
    full."""
    align = _dw_align(C, sl, itemsize)
    p = t_dw.plan(B, H, W, C, k, k, 132, itemsize=itemsize, align=align)
    cv = p["cv"]
    tiles = [c for c in t_dw.candidates(B, H, W, C, k, k, 132,
                                        itemsize=itemsize, align=align)
             if c["threads"] >= t_dw.MIN_THREADS]
    assert p["threads"] >= t_dw.MIN_THREADS
    if max(c["ctas"] for c in tiles) >= 132:
        assert p["ctas"] >= 132
    else:
        assert p["est_us"] == min(c["est_us"] for c in tiles)
    if B == 16:
        assert p["ctas"] >= 132
    assert p["smem"] == t_dw.smem_bytes(p["th"], p["tw"], p["cb"], k, k,
                                        itemsize, cv) <= t_dw.SMEM_BYTES
    assert p["threads"] == p["cb"] // cv * p["tw"] // t_dw.SW * p["th"] \
        <= t_dw.MAX_THREADS
    assert p["th"] <= H and p["tw"] <= t_dw.SW * _cdiv(W, t_dw.SW)
    assert p["tw"] % t_dw.SW == 0 and p["cb"] % cv == 0
    last = C - (_cdiv(C, p["cb"]) - 1) * p["cb"]
    assert 2 * last >= p["cb"]
    assert p["ctas"] == B * _cdiv(H, p["th"]) * _cdiv(W, p["tw"]) \
        * _cdiv(C, p["cb"])


@pytest.mark.parametrize("C", [1, 3, 4, 33, 48, 52, 54, 76, 96, 160, 304])
def test_depthwise_chunks_are_even_and_at_least_half_full(C):
    """Each chunk width C may be split in: a multiple of CV, and C split
    into chunks of it leaves the last one at least half full (C = 48, 76,
    54, 52 split evenly, never 32 + remainder)."""
    for cv in [v for v in (1, 2, 4) if C % v == 0]:
        widths = t_dw.chunk_widths(C, cv)
        assert widths[0] == C and C // cv * cv in widths
        for cb in widths:
            last = C - (_cdiv(C, cb) - 1) * cb
            assert cb % cv == 0 and 2 * last >= cb
    assert 32 not in t_dw.chunk_widths(48, 4)
    assert 32 not in t_dw.chunk_widths(76, 4)


@pytest.mark.parametrize("C,itemsize,sl,cv", [
    (48, 4, None, (4,)), (54, 4, (160, 54), (2,)), (54, 2, (160, 54), (2, 1)),
    (52, 4, None, (4,)), (76, 4, (304, 76), (4,)), (53, 2, (160, 53), (1,)),
    (3, 4, None, (1,)), (54, 4, None, (2,))],
    ids=["dense48", "f32_slice54", "bf16_slice54", "dense52", "slice76",
         "bf16_slice53", "c3", "dense54"])
def test_depthwise_vector_width_follows_alignment(C, itemsize, sl, cv):
    """CV comes from C, the slice's start and its pixel stride together:
    a dense C = 48 float32 reads 4 channels a vector; the float32 slice
    at channel 54 of 160 starts 216 bytes in (8-byte aligned): 2; the
    bf16 slice there 108 bytes in (4-byte aligned): 2 or 1."""
    align = _dw_align(C, sl, itemsize)
    assert t_dw.vector_width(C, itemsize, align) in cv
    assert t_dw.plan(1, 16, 16, C, 3, 3, 132, itemsize=itemsize,
                     align=align)["cv"] in cv
    x = torch.zeros(1, 2, 3, (sl or (C, 0))[0],
                    dtype=torch.float32 if itemsize == 4 else torch.bfloat16)
    start = (sl or (C, 0))[1]
    view = x[..., start:start + C]
    w = torch.zeros(3, 3, C, dtype=x.dtype)
    assert t_dw.alignment(view, w, t_dw._pixel_stride(view)) == math.gcd(
        x.data_ptr() + start * itemsize, w.data_ptr(),
        (sl or (C, 0))[0] * itemsize, 16)


def test_depthwise_plan_refuses_too_many_taps():
    with pytest.raises(ValueError, match="taps"):
        t_dw.plan(1, 8, 8, 4, 16, 15, 132)


@pytest.mark.parametrize("B,H,W,C,fy,fx,sl", [
    (2, 12, 12, 24, 3, 3, None), (2, 10, 14, 52, 5, 5, None),
    (1, 16, 16, 20, 7, 7, None), (2, 8, 8, 12, 9, 9, None),
    (1, 6, 7, 5, 4, 2, None), (2, 3, 5, 6, 7, 7, None),
    (2, 9, 7, 13, 3, 3, (40, 13)), (1, 16, 16, 54, 3, 3, (160, 54)),
    (1, 5, 6, 3, 1, 1, None), (1, 12, 12, 2, 11, 11, None)],
    ids=["k3", "k5", "k7", "k9", "even_4x2", "h_w_under_k", "slice_13",
         "slice_54", "k1", "k11"])
def test_depthwise_tiles_match_jax(B, H, W, C, fy, fx, sl):
    """The kernel's tiling and arithmetic at the tile ``plan`` picks on a
    132-SM card (small shapes: many small tiles, ragged at the image's
    edge) against the JAX Pallas kernel in interpret mode on the same
    inputs within 3e-5.  Covers each compiled (fy, fx), an even kernel
    padded as JAX pads it, H and W smaller than the kernel, channel
    slices and sizes the generic instance takes."""
    r = _rng(43)
    total, start = sl or (C, 0)
    wide = r.standard_normal((B, H, W, total)).astype(np.float32)
    x = wide[..., start:start + C]
    wt = (r.standard_normal((fy, fx, C)) * 0.2).astype(np.float32)
    b = (r.standard_normal((C,)) * 0.1).astype(np.float32)
    want = jops.depthwise_conv2d(jnp.asarray(np.ascontiguousarray(x)),
                                 jnp.asarray(wt), jnp.asarray(b), block_c=C,
                                 interpret=True)
    p = t_dw.plan(B, H, W, C, fy, fx, 132, align=_dw_align(C, sl, 4))
    got = _dw_emulated(_t(wide)[..., start:start + C], _t(wt), _t(b), p)
    _close(got.numpy(), want, 3e-5)


def test_depthwise_every_tile_gives_the_same_bits():
    """Every tile ``candidates`` lists for a ragged shape gives the same
    bits: a tile changes which block computes an output, never its sum."""
    r = _rng(44)
    x, wt, b = (_t(r.standard_normal(s).astype(np.float32))
                for s in ((1, 9, 7, 12), (3, 3, 12), (12,)))
    tiles = t_dw.candidates(1, 9, 7, 12, 3, 3, 132)
    assert len({(p["th"], p["tw"], p["cb"]) for p in tiles}) > 10
    first = _dw_emulated(x, wt, b, tiles[0])
    for p in tiles[1:]:
        assert torch.equal(_dw_emulated(x, wt, b, p), first)


# ---------------------------------------------------------------------------
# matmul + LayerNorm epilogue
# ---------------------------------------------------------------------------


def _mln_inputs(seed, m, k, n):
    r = _rng(seed)
    x = r.standard_normal((m, k)).astype(np.float32)
    w = (r.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b, be = (r.standard_normal((2, n)) * 0.1).astype(np.float32)
    g = (1.0 + r.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b, g, be


@pytest.mark.parametrize("m,k,n,bm,bk,dtype", [
    (64, 32, 48, 32, 16, "float32"),
    (197, 48, 160, 64, 32, "float32"),     # ragged m and k
    (160, 304, 48, 32, 128, "float32"),
    (7, 13, 24, 4, 8, "float32"),          # both blocks below the extents' 8
    (197, 48, 160, 64, 32, "bfloat16"),
    (7, 13, 24, 4, 8, "bfloat16"),
])
def test_matmul_ln_matches_jax(m, k, n, bm, bk, dtype):
    """The JAX Pallas kernel (interpret mode, its own blocks) against the
    port's entry point on a CPU tensor with the blocks the Hopper lowering
    gives the same extents."""
    arrs = _mln_inputs(3, m, k, n)
    want = jops.matmul_ln(*[jnp.asarray(a, dtype=dtype) for a in arrs],
                          block_m=bm, block_k=bk)
    blocks = t_lower.lower_matmul_ln(
        Layer("mac", "pwconv", k=n, c=k, ox=m), Layer("ln", "norm", c=n, ox=m),
        tile_x=64, tile_c=128).params
    got = tops.matmul_ln(*[_t(a).to(getattr(torch, dtype)) for a in arrs],
                         **blocks)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           3e-5 if dtype == "float32" else 2e-2)


def test_matmul_ln_ref_matches_jax_ref():
    """The two plain versions: mean first, biased variance as the mean of
    squared deviations, eps inside the rsqrt."""
    arrs = _mln_inputs(4, 33, 70, 90)
    arrs[2][:] += 30.0            # b: a large row mean, where E[y^2] - E[y]^2 fails
    want = jref.matmul_ln_ref(*[jnp.asarray(a) for a in arrs])
    got = tref.matmul_ln_ref(*[_t(a) for a in arrs])
    _close(got.numpy(), np.asarray(want), 3e-5)


def test_matmul_ln_on_cpu_takes_any_blocks():
    arrs = [_t(a) for a in _mln_inputs(5, 9, 10, 11)]
    want = tref.matmul_ln_ref(*arrs).numpy()
    for blocks in ({}, dict(block_m=3, block_k=1000), dict(block_m=256)):
        np.testing.assert_array_equal(tops.matmul_ln(*arrs, **blocks).numpy(),
                                      want)
    np.testing.assert_array_equal(
        tref.PLAIN.matmul_ln(*arrs, block_m=8, block_k=16).numpy(), want)


# the matmul_ln kernel's own arithmetic, on the CPU: how plan() splits N
# over a cluster, the statistics summed over the slices, and the 3xTF32
# products in K slabs


_MLN_PLAN_SHAPES = [
    (16384, 96, 64), (4096, 160, 64), (1024, 304, 64), (512, 2048, 16),
    (448, 2560, 16), (64, 304, 64), (1, 2560, 16), (7, 2560, 16),
    (197, 160, 32), (7, 24, 8), (5, 7, 8), (64, 13, 8), (33, 90, 32)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("m,n,bm", _MLN_PLAN_SHAPES)
def test_matmul_ln_plan_slices_n_over_the_cluster(m, n, bm, sms):
    """The cluster size is one of 1, 2, 4, 8 and at most the 8-column
    groups of N; the slices cover N contiguously, each a multiple of 8
    columns but the last, none empty, their groups differing by one at
    most; the grid is (splits, row tiles) and ``ctas`` its blocks."""
    p = t_mln.plan(m, n, sms, block_m=bm)
    s, sl = p["splits"], p["slices"]
    assert s in t_mln.CLUSTER and s <= 8 and s <= _cdiv(n, 8)
    assert len(sl) == s and sl[0][0] == 0 and sl[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    widths = [hi - lo for lo, hi in sl]
    assert min(widths) > 0
    assert all(w % 8 == 0 for w in widths[:-1])
    groups = [_cdiv(w, 8) for w in widths]
    assert max(groups) - min(groups) <= 1
    assert p["grid"] == (s, _cdiv(m, bm))
    assert p["ctas"] == s * _cdiv(m, bm)


@pytest.mark.parametrize("m,n,bm,splits", [
    (16384, 96, 64, 1), (4096, 160, 64, 2), (1024, 304, 64, 8),
    (512, 2048, 16, 8), (448, 2560, 16, 8)],
    ids=["b16_96", "b16_160", "b16_304", "rwkv6", "recurrentgemma"])
def test_matmul_ln_plan_fills_the_card_where_row_tiles_do_not(m, n, bm,
                                                              splits):
    """At the three EdgeNeXt-S B = 16 shapes and the two LM widths the
    lowering gives (16-256 row tiles) on a 132-SM card: split until the
    grid fills the card, further only while a slice keeps a whole step of
    columns (the LM widths, 256-320 columns a slice)."""
    p = t_mln.plan(m, n, 132, block_m=bm)
    assert p["splits"] == splits
    assert p["ctas"] >= t_mln.FILL * 132
    if splits > 1 and p["ctas"] // 2 >= t_mln.FILL * 132:
        # split past filling the card: each slice still a whole step
        assert min(hi - lo for lo, hi in p["slices"]) >= t_mln.BLOCK_N[bm]


@pytest.mark.parametrize("n,splits", [(304, 8), (160, 2), (2560, 8), (7, 1),
                                      (90, 8)])
def test_matmul_ln_cluster_statistics_match_ref(n, splits):
    """The kernel's statistics: per-slice partial sums added in rank order
    0..S-1 for the mean, then per-slice squared deviations about that mean,
    the LayerNorm of x @ w + b the plain version takes."""
    x, w, b, g, be = [_t(a) for a in _mln_inputs(34, 37, 50, n)]
    y = x @ w + b
    sl = t_mln.slices(n, splits)
    mean = sum(y[:, lo:hi].sum(-1) for lo, hi in sl) / n
    var = sum(torch.square(y[:, lo:hi] - mean[:, None]).sum(-1)
              for lo, hi in sl) / n
    got = (y - mean[:, None]) * torch.rsqrt(var + 1e-6)[:, None] * g + be
    _close(got.numpy(), tref.matmul_ln_ref(x, w, b, g, be).numpy(), 3e-5)


def _slab_mm(a, b, terms, slab):
    """a @ b as the kernel takes it: each K slab on the tensor cores
    (``_tf32_mm``) summed from zero, the slabs added in float32."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], slab):
        acc = acc + _tf32_mm(a[:, k0:k0 + slab], b[k0:k0 + slab], terms)
    return acc


@pytest.mark.parametrize("m,k,n", [(1024, 304, 304), (64, 2048, 2048)],
                         ids=["edgenext_b16_304", "rwkv6_width"])
def test_matmul_ln_3xtf32_holds_the_float32_tolerance(m, k, n):
    """LayerNorm of the 3xTF32 product (K slabs of ``SLAB_K``, w ~ N(0,
    1/K)) stays within 3e-5 (1 + |b|) of the float32 plain version; one
    TF32 term does not."""
    x, w, b, g, be = [_t(a) for a in _mln_inputs(35, m, k, n)]
    want = tref.matmul_ln_ref(x, w, b, g, be)
    err = {}
    for terms in (1, 3):
        y = _slab_mm(x, w, terms, t_mln.SLAB_K) + b
        mean = y.mean(-1, keepdim=True)
        var = torch.square(y - mean).mean(-1, keepdim=True)
        got = (y - mean) * torch.rsqrt(var + 1e-6) * g + be
        err[terms] = float(((got - want).abs() / (1 + want.abs())).max())
    assert err[3] <= 3e-5 < err[1]


# ---------------------------------------------------------------------------
# chunked WKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, bh, t, k, v):
    """As the JAX WKV tests draw them: N(0, 0.5^2), logw = -exp(N(0, 0.5^2))."""
    r = _rng(seed)
    n = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    return (n(bh, t, k), n(bh, t, k), n(bh, t, v),
            (-np.exp(r.standard_normal((bh, t, k)) * 0.5)).astype(np.float32),
            n(bh, k))


@pytest.mark.parametrize("t,chunk", [(50, 16), (33, 8), (100, 64), (64, 8),
                                     (64, 32)])
def test_wkv_chunked_matches_jax(t, chunk):
    """The JAX Pallas kernel (interpret mode) at ragged T and two chunks of
    one T against the port's entry point on a CPU tensor (the per-token
    ``wkv_ref`` that the CUDA kernel is held against on the card); 2e-4,
    the JAX WKV tests' tolerance (tests/test_kernels.py:282-335)."""
    arrs = _wkv_inputs(7, 4, t, 8, 8)
    want_o, want_s = jops.wkv_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                      interpret=True)
    got_o, got_s = tops.wkv_chunked(*map(_t, arrs), chunk=chunk)
    assert got_o.dtype == torch.float32 and tuple(got_o.shape) == (4, t, 8)
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (4, 8, 8)
    _close(got_o.numpy(), want_o, 2e-4)
    _close(got_s.numpy(), want_s, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_ref_matches_jax_ref(dtype):
    """The two per-token plain versions, with V != K, and in bfloat16 r/k/v
    with float32 logw and u (the served model's types)."""
    r, k, v, w, u = _wkv_inputs(8, 3, 21, 8, 12)
    cast_j = lambda a: jnp.asarray(a, dtype=dtype)          # noqa: E731
    cast_t = lambda a: _t(a).to(getattr(torch, dtype))      # noqa: E731
    want_o, want_s = jref.wkv_ref(cast_j(r), cast_j(k), cast_j(v),
                                  jnp.asarray(w), jnp.asarray(u))
    got_o, got_s = tref.wkv_ref(cast_t(r), cast_t(k), cast_t(v), _t(w), _t(u))
    assert got_o.dtype == getattr(torch, dtype) and got_s.dtype == torch.float32
    tol = 2e-4 if dtype == "float32" else 2e-2
    _close(got_o.float().numpy(), np.asarray(want_o, np.float32), tol)
    _close(got_s.numpy(), want_s, 2e-4)


def test_wkv_smem_budget_covers_the_searched_chunks():
    """k and the decay cumsum of a whole chunk live in shared memory: every
    pow2 chunk 8..256 at K <= 64 fits a block, 512 at K = 64 does not."""
    for chunk in (8, 16, 32, 64, 128, 256):
        for k in (1, 8, 16, 64):
            assert t_wkv.smem_bytes(chunk, k) <= t_wkv.SMEM_LIMIT
    assert t_wkv.smem_bytes(256, 64) == 190864
    assert t_wkv.smem_bytes(512, 64) > t_wkv.SMEM_LIMIT


LOG2E = 1.4426950408889634


def _wkv_emulated(r, k, v, logw, u, *, chunk, terms=3, rho_at="tile"):
    """csrc/wkv_chunked.cu's two passes in torch, float32, every product
    through ``_tf32_mm`` with ``terms``.  States pass: slabs of SLAB rows
    cut at chunk boundaries, b = cumsum(logw log2 e) over the slab,
    S <- 2^{b_e - b_a} S + (k 2^{b_e - b})^T v a segment, the state
    entering each chunk kept.  Outputs pass, each tile of TILE rows: its
    SUB-row diagonal blocks exact (one 2^{b_prev[t] - b[s]} a term, the
    bonus on their diagonal), the block below the first factored about
    b_prev at its first row, q = r 2^{b_prev - rho}, each earlier tile's
    block q @ (k 2^{rho - b})^T and inter = (q 2^rho) @ S, with rho =
    b_prev at the tile's first row (``rho_at="chunk"``: 0, the chunk's
    start, as SNIPPETS.md snippet 3 takes it)."""
    sub, slab, tile = t_wkv.SUB, t_wkv.SLAB, t_wkv.TILE
    r, k, v, logw, u = (t.float() for t in (r, k, v, logw, u))
    BH, T, K = r.shape
    C = min(chunk, T)
    mm = lambda a, b: _tf32_mm(a, b, terms)        # noqa: E731
    w2 = logw * LOG2E
    S = torch.zeros(BH, K, v.shape[2])
    entering = []
    for r0 in range(0, T, slab):
        n = min(slab, T - r0)
        b = torch.cumsum(w2[:, r0:r0 + n], 1)
        a = 0
        while a < n:
            ga, e = r0 + a, min(n, (r0 + a) // C * C + C - r0)
            if ga % C == 0:
                entering.append(S)
            kd = k[:, ga:r0 + e] * torch.exp2(b[:, e - 1:e] - b[:, a:e])
            pre = b[:, a - 1] if a else torch.zeros(BH, K)
            S = torch.exp2(b[:, e - 1] - pre)[..., None] * S \
                + mm(kd.transpose(1, 2).contiguous(), v[:, ga:r0 + e])
            a = e
    out = torch.empty(v.shape)
    for c, S_in in enumerate(entering):
        c0, n = c * C, min(C, T - c * C)
        bz = torch.cat([torch.zeros(BH, 1, K),
                        torch.cumsum(w2[:, c0:c0 + n], 1)], 1)
        rc, kc, vc = r[:, c0:c0 + n], k[:, c0:c0 + n], v[:, c0:c0 + n]
        for j0 in range(0, n, tile):
            j1 = min(n, j0 + tile)
            rho = bz[:, j0] if rho_at == "tile" else torch.zeros(BH, K)
            # the tile's block: exact SUB x SUB diagonal blocks (the bonus on
            # their diagonal), the block below the first factored about
            # b_prev at its first row
            D = torch.zeros(BH, j1 - j0, j1 - j0)
            for b0 in range(j0, j1, sub):
                b1 = min(j1, b0 + sub)
                mask = torch.tril(torch.ones(b1 - b0, b1 - b0, dtype=torch.bool), -1)
                diff = bz[:, b0:b1, None] - bz[:, None, b0 + 1:b1 + 1]
                dec = torch.exp2(torch.where(mask[None, :, :, None], diff,
                                             torch.tensor(-math.inf)))
                D[:, b0 - j0:b1 - j0, b0 - j0:b1 - j0] = torch.einsum(
                    "btk,bsk,btsk->bts", rc[:, b0:b1], kc[:, b0:b1], dec) \
                    + torch.diag_embed((rc[:, b0:b1] * u[:, None] * kc[:, b0:b1]).sum(-1))
                if b0 > j0:
                    r8 = bz[:, b0]
                    q8 = rc[:, b0:b1] * torch.exp2(bz[:, b0:b1] - r8[:, None])
                    k8 = kc[:, j0:b0] * torch.exp2(r8[:, None] - bz[:, j0 + 1:b0 + 1])
                    D[:, b0 - j0:b1 - j0, :b0 - j0] = mm(q8, k8.transpose(1, 2).contiguous())
            acc = mm(D, vc[:, j0:j1])
            q = rc[:, j0:j1] * torch.exp2(bz[:, j0:j1] - rho[:, None])
            for s0 in range(0, j0, tile):
                kdec = kc[:, s0:s0 + tile] * torch.exp2(
                    rho[:, None] - bz[:, s0 + 1:s0 + tile + 1])
                acc = acc + mm(mm(q, kdec.transpose(1, 2).contiguous()),
                               vc[:, s0:s0 + tile])
            acc = acc + mm(q * torch.exp2(rho)[:, None], S_in)
            out[:, c0 + j0:c0 + j1] = acc
    return out, S


def _wkv_decayed_inputs(seed, bh, t, k, v, decay):
    """``_wkv_inputs`` with logw = -exp(N(0, 0.5^2)) ("normal"), -exp(N(2.5,
    1)) ("extreme": single steps near -40, a chunk's decay past e^88), 0
    ("zero") or -1e-6 ("tiny")."""
    r, kk, vv, w, u = _wkv_inputs(seed, bh, t, k, v)
    if decay != "normal":
        z = _rng(seed + 1).standard_normal((bh, t, k))
        w = {"extreme": -np.exp(2.5 + z), "zero": np.zeros_like(z),
             "tiny": np.full_like(z, -1e-6)}[decay].astype(np.float32)
    return r, kk, vv, w, u


# seed, bh, T, K, V, chunk, decay
_WKV_EMU_CASES = {
    "ragged_c8_sub8": (40, 2, 50, 16, 16, 8, "normal"),
    "ragged_c16": (41, 2, 50, 16, 16, 16, "normal"),
    "ragged_c33_sub8": (42, 2, 100, 16, 24, 33, "normal"),
    "ragged_c64_served_width": (43, 2, 100, 64, 64, 64, "normal"),
    "ragged_c64_slab_over_chunks": (44, 2, 150, 16, 16, 50, "normal"),
    "c256": (45, 1, 300, 8, 8, 256, "normal"),
    "k1_v2560": (46, 1, 48, 1, 2560, 16, "normal"),
    "k8_v40": (47, 2, 100, 8, 40, 32, "normal"),
    "extreme_decay": (48, 2, 128, 16, 16, 64, "extreme"),
    "extreme_decay_sub8": (52, 2, 128, 16, 16, 64, "extreme"),
    "zero_decay": (49, 2, 70, 16, 16, 32, "zero"),
    "tiny_decay": (50, 2, 70, 16, 16, 32, "tiny"),
}


@pytest.mark.parametrize("case", list(_WKV_EMU_CASES))
def test_wkv_two_pass_emulation_matches_jax(case):
    """The CUDA kernel's algorithm (``_wkv_emulated``: two passes, sub-chunk
    factored products in 3xTF32) against the JAX Pallas kernel in
    interpret mode, 2e-4: ragged T at chunks 8-256, K = 1 with V = 2560,
    K = 8 with V = 40, slabs across chunk boundaries, decays at the
    extremes (finite)."""
    seed, bh, t, k, v, chunk, decay = _WKV_EMU_CASES[case]
    arrs = _wkv_decayed_inputs(seed, bh, t, k, v, decay)
    want_o, want_s = jops.wkv_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                      interpret=True)
    got_o, got_s = _wkv_emulated(*map(_t, arrs), chunk=chunk)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    _close(got_o.numpy(), want_o, 2e-4)
    _close(got_s.numpy(), want_s, 2e-4)


def test_wkv_chunk_start_reference_overflows_at_extreme_decays():
    """Factoring the earlier sub-chunks' blocks about the chunk's start
    (k e^{-b[s]}, SNIPPETS.md snippet 3) overflows float32 once a chunk's
    decay passes e^88, which RWKV-6's decays reach; about b_prev at each
    tile's first row every factor is at most 1 and the result holds."""
    seed, bh, t, k, v, chunk, _ = _WKV_EMU_CASES["extreme_decay"]
    arrs = [_t(a) for a in _wkv_decayed_inputs(seed, bh, t, k, v, "extreme")]
    assert float(-arrs[3][:, :chunk].sum(1).min()) > 88
    at_start, _ = _wkv_emulated(*arrs, chunk=chunk, rho_at="chunk")
    at_sub, _ = _wkv_emulated(*arrs, chunk=chunk)
    assert not torch.isfinite(at_start).all()
    assert torch.isfinite(at_sub).all()
    _close(at_sub.numpy(), tref.wkv_ref(*arrs)[0].numpy(), 2e-4)


def test_wkv_3xtf32_holds_the_float32_tolerance():
    """At the served width (K = V = 64, chunk 64, 16-row tiles) three
    TF32 terms a product stay within 2e-4 (1 + |b|) of the per-token
    recurrence; one term does not."""
    arrs = [_t(a) for a in _wkv_inputs(51, 2, 128, 64, 64)]
    want_o, want_s = tref.wkv_ref(*arrs)
    err = {}
    for terms in (1, 3):
        got_o, got_s = _wkv_emulated(*arrs, chunk=64, terms=terms)
        err[terms] = max(float(((got_o - want_o).abs() / (1 + want_o.abs())).max()),
                         float(((got_s - want_s).abs() / (1 + want_s.abs())).max()))
    assert err[3] <= 2e-4 < err[1]


@pytest.mark.parametrize("bh,t", [(128, 512), (32, 200)], ids=["b4x512", "b1x200"])
def test_wkv_plan_fills_the_card(bh, t):
    """At RWKV-6's prefill shapes (32 heads of 64, chunk 64, bf16 r/k/v,
    float32 logw) both passes launch at least a block for every SM, within
    the shared memory a block may have."""
    p = t_wkv.plan(bh, t, 64, 64, 64, 2, logw_itemsize=4, sms=132)
    assert p["ctas"] >= 132 and p["states_ctas"] >= 132
    assert p["smem"] <= t_wkv.SMEM_LIMIT and p["states_smem"] <= t_wkv.SMEM_LIMIT


@pytest.mark.parametrize("k,v", [(64, 64), (1, 2560), (8, 40)])
@pytest.mark.parametrize("chunk", [1, 8, 16, 32, 33, 50, 64, 128, 256])
def test_wkv_plan_is_one_the_kernel_runs(k, v, chunk):
    """Every plan at the searched chunks (and odd ones) keeps the C entry's
    rules: built warps a tile, rows a multiple of the tile within the chunk
    rounded up to it, whole groups of warps, at most one group a tile,
    both passes within SMEM_LIMIT in float32 and bf16."""
    for isz in (4, 2):
        p = t_wkv.plan(4, 300, k, v, chunk, isz, sms=132)
        assert p["wv"] in t_wkv.WVS
        tile = t_wkv.TILE
        cp = -(-chunk // tile) * tile
        assert p["rows"] % tile == 0 and tile <= p["rows"] <= cp
        assert p["warps"] % p["wv"] == 0 and p["warps"] <= t_wkv.MAX_WARPS
        assert 1 <= p["warps"] // p["wv"] <= p["rows"] // tile
        assert p["smem"] <= t_wkv.SMEM_LIMIT
        assert p["states_smem"] <= t_wkv.SMEM_LIMIT


def test_wkv_wrapper_checks_before_anything_else():
    r = torch.zeros(2, 5, 4)
    u = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="shapes"):
        t_wkv.wkv_chunked(r, r, torch.zeros(2, 6, 4), r, u, chunk=4)
    with pytest.raises(ValueError, match="shapes"):
        t_wkv.wkv_chunked(r, r, r, r, torch.zeros(2, 3), chunk=4)
    with pytest.raises(ValueError, match="at least 1"):
        t_wkv.wkv_chunked(r, r, r, r, u, chunk=0)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 512, 64)
        t_wkv.wkv_chunked(big, big, big, big, torch.zeros(1, 64), chunk=512)
    with pytest.raises(TypeError, match="logw"):
        t_wkv.wkv_chunked(r.bfloat16(), r.bfloat16(), r.bfloat16(), r.half(),
                          u, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):          # then the device
        t_wkv.wkv_chunked(r.bfloat16(), r.bfloat16(), r.bfloat16(), r, u,
                          chunk=4)


# ---------------------------------------------------------------------------
# routing, wrappers, build: what can be checked without a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda: t_ibn.fused_ibn(torch.zeros(4, 8), torch.zeros(8, 16),
                            torch.zeros(16, 8)),
    lambda: t_fa.flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                                 torch.zeros(1, 1, 4, 8)),
    lambda: t_dw.depthwise_conv2d(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8),
                                  torch.zeros(8)),
    lambda: t_mln.matmul_ln(torch.zeros(4, 8), torch.zeros(8, 16),
                            *[torch.zeros(16)] * 3, block_m=8, block_k=16),
    lambda: t_wkv.wkv_chunked(*[torch.zeros(2, 5, 4)] * 4, torch.zeros(2, 4),
                              chunk=4),
], ids=["fused_ibn", "flash_attention", "depthwise_conv2d", "matmul_ln",
        "wkv_chunked"])
def test_kernel_wrapper_refuses_cpu_tensor(call):
    """The wrappers launch or raise; only ``ops`` sends a CPU tensor to
    the plain version.  No launch is counted."""
    before = (t_ibn.launches, t_fa.launches, t_dw.launches, t_mln.launches,
              t_wkv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert (t_ibn.launches, t_fa.launches, t_dw.launches,
            t_mln.launches, t_wkv.launches) == before


def test_ops_on_cpu_counts_no_launch():
    before = (t_ibn.launches, t_fa.launches, t_dw.launches, t_wkv.launches)
    tops.fused_ibn(torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(16, 8))
    tops.flash_attention(*[torch.zeros(1, 1, 4, 8)] * 3)
    tops.depthwise_conv2d(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8),
                          torch.zeros(8))
    tops.wkv_chunked(*[torch.zeros(2, 5, 4)] * 4, torch.zeros(2, 4), chunk=2)
    assert (t_ibn.launches, t_fa.launches, t_dw.launches,
            t_wkv.launches) == before


def test_pixel_stride_takes_dense_and_channel_slices_only():
    x = torch.zeros(2, 5, 6, 16)
    assert t_dw._pixel_stride(x) == 16
    assert t_dw._pixel_stride(x[..., 4:12]) == 16
    assert t_dw._pixel_stride(torch.zeros(2, 1, 1, 16)) == 16
    assert t_dw._pixel_stride(torch.zeros(2, 1, 1, 48)[..., 8:32]) == 48
    assert t_dw._pixel_stride(torch.zeros(1, 1, 1, 48)[..., 8:32]) == 24
    for bad in (x[:, ::2], x[:, 1:4, 1:4], x.permute(0, 2, 1, 3),
                x[..., ::2]):
        with pytest.raises(ValueError):
            t_dw._pixel_stride(bad)


def test_wrappers_check_shapes_before_anything_else():
    with pytest.raises(ValueError):
        t_ibn.fused_ibn(torch.zeros(4, 8), torch.zeros(9, 16), torch.zeros(16, 8))
    with pytest.raises(ValueError):
        t_ibn.fused_ibn(torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(16, 8),
                        activation="tanh")
    with pytest.raises(ValueError):
        t_fa.flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 6),
                             torch.zeros(1, 1, 4, 6))
    with pytest.raises(ValueError):
        t_dw.depthwise_conv2d(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 7),
                              torch.zeros(8))
    with pytest.raises(ValueError, match="shapes"):
        t_mln.matmul_ln(torch.zeros(4, 8), torch.zeros(8, 16),
                        *[torch.zeros(15)] * 3, block_m=8, block_k=16)
    with pytest.raises(ValueError, match="built for"):
        t_mln.matmul_ln(torch.zeros(4, 8), torch.zeros(8, 16),
                        *[torch.zeros(16)] * 3, block_m=128, block_k=16)
    with pytest.raises(ValueError, match="budget"):
        t_mln.matmul_ln(torch.zeros(4, 8), torch.zeros(8, 2600),
                        *[torch.zeros(2600)] * 3, block_m=16, block_k=16)


def test_plain_namespace_has_the_signatures_of_ops():
    x, w1, w2, _ = _ibn_inputs(11, 8, 4, 16, 4, False)
    np.testing.assert_array_equal(
        tref.PLAIN.fused_ibn(_t(x), _t(w1), _t(w2), activation="gelu",
                             block_m=8).numpy(),
        tops.fused_ibn(_t(x), _t(w1), _t(w2)).numpy())
    q, k, v = _qkv(12, 1, 1, 6, 6, 4)
    np.testing.assert_array_equal(
        tref.PLAIN.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                   scale=1.0).numpy(),
        tops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                             scale=1.0).numpy())
    arrs = [_t(a) for a in _wkv_inputs(13, 2, 9, 4, 6)]
    for got, want in zip(tref.PLAIN.wkv_chunked(*arrs, chunk=4),
                         tops.wkv_chunked(*arrs, chunk=4)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_build_is_keyed_by_the_sources_and_lazy():
    names = sorted(p.name for p in _build.sources())
    assert names == ["adamw.cu", "depthwise_conv.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "fused_ibn.cu", "matmul_ln.cu",
                     "wkv_chunked.cu", "wkv_chunked_bwd.cu"]
    assert _build.build_dir() == _build.build_dir()
    assert _build.build_dir().parent.name == "repro_torch_kernels"
    assert "compute_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    if shutil.which("nvcc") is None and _build._lib is None:
        # importing the package built nothing and loaded nothing
        assert _build.build_seconds is None


def test_build_dir_hashes_the_headers_too(tmp_path, monkeypatch):
    """Editing a header the kernels include (``csrc/*.cuh``) rebuilds the
    library; only the ``*.cu`` are compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.headers()] == ["cp_async.cuh", "ldmatrix.cuh",
                                                  "mma.cuh"]
    assert all(p.suffix == ".cu" for p in _build.sources())
    for header in _build.headers():
        before = _build.build_dir()
        header.write_text(header.read_text() + "\n")
        assert _build.build_dir() != before


def test_profile_matmul_ln_instruments_the_kernel_source():
    """The phase profiler's stamps still find their places in
    csrc/matmul_ln.cu (it compiles only on the card): the slab loop, the
    three cluster barriers and the block's end, each once."""
    from repro_torch import profile_matmul_ln
    src = profile_matmul_ln.instrumented_source()
    for slot in range(7):
        assert src.count(f"prof_t[{slot}] = prof_now();") == 1
    assert "extern \"C\" int profile_occupancy(" in src


def test_profile_depthwise_instruments_the_kernel_source():
    """The depthwise phase profiler's stamps still find their places in
    csrc/depthwise_conv.cu (it compiles only on the card): the block's
    start, the halo landed, the taps done and the store, each once, in
    that order."""
    from repro_torch import profile_depthwise
    src = profile_depthwise.instrumented_source()
    at = [src.index(f"prof_t[{slot}] = prof_now();") for slot in range(4)]
    assert at == sorted(at)
    for slot in range(4):
        assert src.count(f"prof_t[{slot}] = prof_now();") == 1
    assert "extern \"C\" int profile_read(" in src


def test_profile_wkv_instruments_the_kernel_source():
    """The WKV phase profiler's stamps still find their places in
    csrc/wkv_chunked.cu (it compiles only on the card): in the states pass
    the copies landed, the cumsum and the products of each slab and the
    block's end; in the outputs pass the copies landed, the cumsum, the
    diagonal block, q, the earlier sub-chunks, inter, the store and the
    warp's end; each once, each in its kernel."""
    from repro_torch import profile_wkv
    src = profile_wkv.instrumented_source()
    states = src.index("wkv_states_kernel(const Tin*")
    outputs = src.index("wkv_outputs_kernel(const Tin*")
    for slot in range(3):
        at = src.index(f"prof_s[{slot}] +=")
        assert src.count(f"prof_s[{slot}] +=") == 1 and states < at < outputs
    for slot in range(7):
        assert src.count(f"prof_o[{slot}] +=") == 1
        assert src.index(f"prof_o[{slot}] +=") > outputs
    assert src.count("prof_span(prof_s, prof_t0)") == 1
    assert src.count("prof_span(prof_o, prof_t0)") == 1
    assert "extern \"C\" int profile_read(" in src
    # both copies launch the passes the switch asks for; the timing copy
    # has no stamps
    plain = profile_wkv.instrumented_source(stamps=False)
    for copy in (src, plain):
        assert copy.count("prof_passes & 1 ? launch_states<Tin>(a, s)") == 1
        assert copy.count("!(prof_passes & 2)") == 1
    assert "prof_now" not in plain


def test_profiles_count_every_kernel_of_the_sources():
    """The request profilers count a device kernel as the port's own by
    name (``profile_edgenext.OURS``): every ``__global__`` function of
    csrc/*.cu is on that list."""
    import re
    from repro_torch import profile_edgenext
    names = set()
    for src in _build.sources():
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    assert names and names <= set(profile_edgenext.OURS), names


def test_profile_flash_attention_instruments_the_kernel_source():
    """The flash attention phase profiler's stamps still find their places
    in csrc/flash_attention.cu (it compiles only on the card): the loads,
    the partial scores, the cluster barrier and sum, the softmax, the
    store and the block's end, each once, all in the whole-row kernel."""
    from repro_torch import profile_flash_attention
    src = profile_flash_attention.instrumented_source()
    rows = src.index("rows_kernel(const T*")
    online = src.index("online_kernel(const T*")
    for slot in range(8):
        at = src.index(f"prof_t[{slot}] = prof_now();")
        assert src.count(f"prof_t[{slot}] = prof_now();") == 1
        assert rows < at < online
    assert "extern \"C\" int profile_read(" in src
