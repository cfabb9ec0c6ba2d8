"""The port's attention backward against the JAX package's, on the CPU.

``ops.flash_attention`` on tensors that require grad goes through
``kernels.flash_attention.FlashAttention``, whose forward and backward run
their plain versions on the CPU (``ref.attention_fwd_lse_ref``,
``ref.attention_bwd_ref``); the same numpy inputs go through
``repro.models.attention.flash_attention`` (its ``custom_vjp``: the blocked
``_flash_fwd`` and ``_flash_bwd``).  Tolerances: 2e-3 for gradients, the JAX
tests' own (``tests/test_attention_lib.py``); 2e-4 where the two compute the
same formulas in float32 and differ only in the order of their sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_attention_bwd as t_fb
from repro_torch.kernels import ops, ref

GRAD_TOL = 2e-3
TOL = 2e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _qkv(seed, sq=64, sk=64, h=2, d=16, b=2):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _leaves(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


def test_flash_bwd_matches_reference():
    """Port of test_attention_lib.py::test_flash_bwd_matches_reference: the
    gradients of sum(out ** 2), causal, against ``jax.grad``."""
    q, k, v = _qkv(1, sq=32, sk=32)
    want = jax.grad(lambda q, k, v: (JA.flash_attention(
        q, k, v, True, None, None, 16, 16) ** 2).sum(), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _leaves((q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert isinstance(out.grad_fn, t_fa.FlashAttention._backward_cls)
    (out ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w, GRAD_TOL)


def test_flash_bwd_windowed():
    """Port of test_attention_lib.py::test_flash_bwd_windowed."""
    q, k, v = _qkv(2)

    def g(q, k, v):
        return (JA.flash_attention(q, k, v, True, 16, None, 16, 16)
                * v.sum(2, keepdims=True)).sum()

    want = jax.grad(g, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    tq, tk, tv = _leaves((q, k, v))
    (ops.flash_attention(tq, tk, tv, causal=True, window=16)
     * tv.sum(2, keepdim=True)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w, GRAD_TOL)


def test_gqa_gradients_sum_over_the_group():
    """K and V of 2 heads repeated over 8 query heads, as the models hand
    them over: the heads' gradients sum over their group, as
    ``jnp.repeat``'s VJP sums them."""
    r = np.random.default_rng(3)
    q = r.standard_normal((2, 8, 40, 16)).astype(np.float32)
    k, v = (r.standard_normal((2, 2, 40, 16)).astype(np.float32) for _ in range(2))
    dout = r.standard_normal(q.shape).astype(np.float32)

    def f(q, k, v):
        out = JA.flash_attention(q, jnp.repeat(k, 4, axis=1),
                                 jnp.repeat(v, 4, axis=1), True, None, None,
                                 8, 8)
        return (out * dout).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    tq, tk, tv = _leaves((q, k, v))
    out = ops.flash_attention(tq, tk.repeat_interleave(4, dim=1),
                              tv.repeat_interleave(4, dim=1), causal=True)
    (out * torch.from_numpy(dout)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), w, GRAD_TOL)


_CASES = {
    # sq, sk, causal, window, block
    "causal": (64, 64, True, None, 16),
    "non_causal_sq_ne_sk": (32, 64, False, None, 16),
    "windowed": (64, 64, True, 16, 16),
    "window_non_causal": (48, 64, False, 8, 16),
    "rows_with_no_key": (64, 16, True, 4, 16),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_fwd_lse_ref_matches_flash_fwd(case):
    """``ref.attention_fwd_lse_ref``'s output and log-sum-exp against the
    reference's ``_flash_fwd`` (a row with no key: lse -1e30 in both)."""
    sq, sk, causal, window, block = _CASES[case]
    q, k, v = _qkv(4, sq=sq, sk=sk)
    out, lse = JA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, window, 16 ** -0.5, block, block)
    t_out, t_lse = ref.attention_fwd_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    _close(t_out.numpy(), out, TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=TOL, atol=TOL)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (2, 2, sq)


@pytest.mark.parametrize("case", list(_CASES))
def test_bwd_ref_matches_flash_bwd(case):
    """``ref.attention_bwd_ref`` against the reference's ``_flash_bwd``
    given the same (q, k, v, out, lse, dout), at Sq != Sk, non-causal,
    windowed, and with rows that see no key (whose P is 1 on the masked
    keys in both: the formulas, not the softmax's derivative)."""
    sq, sk, causal, window, block = _CASES[case]
    q, k, v = _qkv(5, sq=sq, sk=sk)
    dout = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    scale = 16 ** -0.5
    jq, jk, jv, jd = (jnp.asarray(a) for a in (q, k, v, dout))
    out, lse = JA._flash_fwd(jq, jk, jv, causal, window, scale, block, block)
    want = JA._flash_bwd(jq, jk, jv, out, lse, jd, causal, window, scale,
                         block, block)
    got = ref.attention_bwd_ref(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, dout)),
        causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g.numpy(), w, TOL)


def test_ops_takes_the_autograd_function_only_where_a_gradient_is_asked():
    """No grad mode or no input requiring grad: the served call (no
    ``grad_fn``); an input that requires grad under grad mode: the
    ``FlashAttention`` function, with the same output."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    plain = ops.flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None
    tq = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(tq, k, v, causal=True).grad_fn is None
    got = ops.flash_attention(tq, k, v, causal=True)
    assert isinstance(got.grad_fn, t_fa.FlashAttention._backward_cls)
    assert torch.equal(got.detach(), plain)
    # only q requires grad: k and v get none
    got.sum().backward()
    assert tq.grad is not None and k.grad is None and v.grad is None


def test_cpu_plain_versions_of_the_other_kernels_stay_differentiable():
    """On CPU tensors the four entries without a CUDA backward run their
    plain versions, which autograd differentiates (the card refuses such a
    call: ``tests/test_torch_cuda.py``)."""
    r = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                                ).requires_grad_()

    x, w1, w2 = t(5, 8), t(8, 16), t(16, 8)
    ops.fused_ibn(x, w1, w2).sum().backward()
    xm, wm, b, gm, bt = t(5, 8), t(8, 12), t(12), t(12), t(12)
    ops.matmul_ln(xm, wm, b, gm, bt).square().sum().backward()
    xd, wd, bd = t(1, 6, 6, 4), t(3, 3, 4), t(4)
    ops.depthwise_conv2d(xd, wd, bd).sum().backward()
    rr, kk, vv, lw, u = t(2, 5, 4), t(2, 5, 4), t(2, 5, 4), t(2, 5, 4), t(2, 4)
    out, state = ops.wkv_chunked(rr, kk, vv, -torch.exp(lw), u, chunk=2)
    (out.sum() + state.sum()).backward()
    for leaf in (x, w1, w2, xm, wm, b, gm, bt, xd, wd, bd, rr, kk, vv, lw, u):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


def test_backward_wrapper_takes_cuda_tensors_and_d_up_to_256_only():
    """The kernel's wrapper raises on a head wider than D_MAX (with the
    limit in the message) and on CPU tensors: nothing falls back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, d=16))
    out, lse = ref.attention_fwd_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="kernel takes CUDA tensors only"):
        t_fb.flash_attention_bwd(q, k, v, out, lse, out)
    wide = torch.zeros((1, 1, 4, t_fb.D_MAX + 8))
    with pytest.raises(ValueError, match=f"D <= {t_fb.D_MAX}"):
        t_fb.flash_attention_bwd(wide, wide, wide, wide, torch.zeros((1, 1, 4)),
                                 wide)
