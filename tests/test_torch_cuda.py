"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` and skip where there is none.
They import neither JAX nor the JAX package, so they also run where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(seed, *shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return [_t((r.standard_normal(s) * scale).astype(np.float32)).cuda()
            for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_ibn", "flash_attention",
                                    "depthwise_conv2d"])
def test_kernel_on_card_matches_plain(kernel):
    """Each CUDA kernel against its plain version at one odd shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    if kernel == "fused_ibn":
        x, = _normal(13, (197, 49))
        w1, w2, wg = _normal(14, (49, 160), (160, 48), (49, 160), scale=0.1)
        got = tops.fused_ibn(x, w1, w2, wg, activation="silu")
        want = tref.fused_ibn_ref(x, w1, w2, wg, activation="silu")
        tol = 3e-5
    elif kernel == "flash_attention":
        q, k, v = _normal(15, (2, 2, 37, 70), (2, 2, 50, 70), (2, 2, 50, 70))
        got = tops.flash_attention(q, k, v, causal=True, window=9)
        want = tref.attention_ref(q, k, v, causal=True, window=9)
        tol = 2e-4
    else:
        x, wt, b = _normal(16, (2, 9, 7, 40), (5, 5, 13), (13,))
        got = tops.depthwise_conv2d(x[..., 13:26], wt, b)
        want = tref.depthwise_conv2d_ref(x[..., 13:26], wt, b)
        tol = 3e-5
    torch.cuda.synchronize()
    _close(got.cpu().numpy(), want.cpu().numpy(), tol)


_SPLIT_F_CASES = {
    # m, d, f, do, gated, activation, dtype
    "stage4_m64": (64, 305, 1216, 304, False, "gelu", torch.float32),
    "stage4_m1024": (1024, 305, 1216, 304, False, "gelu", torch.float32),
    "ragged_f_last_split": (197, 97, 330, 96, False, "silu", torch.float32),
    "do_over_304": (100, 64, 300, 400, True, "gelu", torch.float32),
    "m1": (1, 305, 1216, 304, False, "relu2", torch.float32),
    "gated_bf16": (64, 161, 640, 160, True, "silu", torch.bfloat16),
}


def _split_f_inputs(case, seed):
    from repro_torch.kernels import fused_ibn as t_ibn
    m, d, f, do, gated, act, dt = _SPLIT_F_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_ibn.plan(m, f, do, sms)["splits"] > 1
    x, = _normal(seed, (m, d))
    w1, w2, wg = _normal(seed + 1, (d, f), (f, do), (d, f), scale=0.1)
    return [t.to(dt) for t in (x, w1, w2)] + [wg.to(dt) if gated else None], act


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SPLIT_F_CASES))
def test_fused_ibn_split_f_on_card_matches_plain(case):
    """fused_ibn with F split over the grid (S > 1, partials reduced in a
    second pass) against its plain version: stage-4 widths at M = 64 and
    1024, a ragged F tile at the end of the last split, Do over two
    blocks, a single row, gated bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    (x, w1, w2, wg), act = _split_f_inputs(case, 23)
    got = tops.fused_ibn(x, w1, w2, wg, activation=act)
    want = tref.fused_ibn_ref(x, w1, w2, wg, activation=act)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           3e-5 if x.dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stage4_m1024", "gated_bf16"])
def test_fused_ibn_split_f_is_bitwise_repeatable(case):
    """The split partials are summed in a fixed order, without atomics:
    two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    (x, w1, w2, wg), act = _split_f_inputs(case, 24)
    first = tops.fused_ibn(x, w1, w2, wg, activation=act)
    second = tops.fused_ibn(x, w1, w2, wg, activation=act)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_launch_counters_count_launches_only():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import fused_ibn as t_ibn
    x, w1, w2 = _normal(17, (8, 4), (4, 16), (16, 4))
    before = t_ibn.launches
    tops.fused_ibn(x, w1, w2)
    tops.fused_ibn(x.cpu(), w1.cpu(), w2.cpu())        # plain version: no launch
    with pytest.raises(ValueError):
        tops.fused_ibn(x.t().contiguous().t(), w1, w2)  # not dense: refused
    torch.cuda.synchronize()
    assert t_ibn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ln_every_instance_on_card_matches_plain(dtype):
    """Every (block_m, block_k) instance of the CUDA matmul_ln against its
    plain version, at a ragged shape (M and K divide by no block), and at
    the widest row buffer the budget allows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import matmul_ln as t_mln
    from repro_torch.search import lower
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 2e-2
    cases = [(197, 77, 160, bm, bk) for bm in lower.MATMUL_LN_BLOCK_M
             for bk in lower.MATMUL_LN_BLOCK_K]
    cases.append((40, 2560, 2560, 16, 64))
    before = t_mln.launches
    for m, k, n, bm, bk in cases:
        x, = _normal(18, (m, k))
        w, b, be = _normal(19, (k, n), (n,), (n,), scale=k ** -0.5)
        g = 1.0 + _normal(20, (n,), scale=0.1)[0]
        args = [t.to(dt) for t in (x, w, b, g, be)]
        got = tops.matmul_ln(*args, block_m=bm, block_k=bk)
        want = tref.matmul_ln_ref(*args)
        torch.cuda.synchronize()
        assert got.dtype == dt
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), tol)
    assert t_mln.launches == before + len(cases)


@pytest.mark.cuda
def test_matmul_ln_on_card_refuses_blocks_it_is_not_built_for():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import matmul_ln as t_mln
    x, w, b = _normal(21, (32, 2560), (2560, 2560), (2560,))
    before = t_mln.launches
    with pytest.raises(ValueError, match="budget"):
        tops.matmul_ln(x, w, b, b, b, block_m=64, block_k=64)
    with pytest.raises(ValueError, match="built for"):
        tops.matmul_ln(x[:, :160].contiguous(),
                       w[:160, :160].contiguous(), b[:160], b[:160], b[:160],
                       block_m=12, block_k=64)
    with pytest.raises(ValueError, match="built for"):
        tops.fused_ibn(x[:, :16].contiguous(), w[:16, :64].contiguous(),
                       w[:64, :16].contiguous(), block_m=128)
    assert t_mln.launches == before


_CLUSTER_CASES = {
    # m, k, n, block_m, dtype
    "n304_over_8": (1024, 304, 304, 64, torch.float32),
    "n160_over_2": (4096, 160, 160, 64, torch.float32),
    "m1_n2560": (1, 2560, 2560, 16, torch.float32),
    "m7_n2560": (7, 2560, 2560, 16, torch.float32),
    "bf16_2048": (512, 2048, 2048, 16, torch.bfloat16),
}


def _cluster_inputs(case, seed):
    from repro_torch.kernels import matmul_ln as t_mln
    m, k, n, bm, dt = _CLUSTER_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_mln.plan(m, n, sms, block_m=bm)["splits"] > 1
    x, = _normal(seed, (m, k))
    w, b, be = _normal(seed + 1, (k, n), (n,), (n,), scale=k ** -0.5)
    g = 1.0 + _normal(seed + 2, (n,), scale=0.1)[0]
    return [t.to(dt) for t in (x, w, b, g, be)], bm


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CLUSTER_CASES))
def test_matmul_ln_cluster_split_on_card_matches_plain(case):
    """matmul_ln with N split over a thread-block cluster against its plain
    version: 304 columns over 8 blocks and 160 over 2 (slices of unequal
    width), one and seven rows at N = 2560, bfloat16 at 512 x 2048."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, bm = _cluster_inputs(case, 25)
    got = tops.matmul_ln(*args, block_m=bm, block_k=64)
    want = tref.matmul_ln_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           3e-5 if args[0].dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_matmul_ln_is_bitwise_repeatable():
    """The row statistics are summed over the cluster in rank order,
    without atomics: two calls at 448 x 2560 -> 2560 give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    x, = _normal(26, (448, 2560))
    w, b, be = _normal(27, (2560, 2560), (2560,), (2560,), scale=2560 ** -0.5)
    g = 1.0 + _normal(28, (2560,), scale=0.1)[0]
    first = tops.matmul_ln(x, w, b, g, be, block_m=16, block_k=64)
    second = tops.matmul_ln(x, w, b, g, be, block_m=16, block_k=64)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_f32", "bf16", "k1_v2560"])
def test_wkv_chunked_on_card_matches_plain(case):
    """The CUDA chunked WKV against ``wkv_ref``: a ragged float32 case
    (T = 50 at chunk 16), the served types (bfloat16 r/k/v, float32 logw
    and u), and RecurrentGemma's lowered K = 1, V = 2560 at chunk 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import rwkv_chunk as t_wkv
    bh, t, k, v, chunk, dt = {
        "ragged_f32": (4, 50, 64, 64, 16, torch.float32),
        "bf16": (8, 100, 64, 64, 64, torch.bfloat16),
        "k1_v2560": (1, 448, 1, 2560, 256, torch.float32)}[case]
    r, kk, vv, w, u = _normal(22, (bh, t, k), (bh, t, k), (bh, t, v), (bh, t, k),
                              (bh, k), scale=0.5)
    logw = -torch.exp(w)
    args = (r.to(dt), kk.to(dt), vv.to(dt), logw, u)
    before = t_wkv.launches
    out, state = tops.wkv_chunked(*args, chunk=chunk)
    want_out, want_state = tref.wkv_ref(*args)
    torch.cuda.synchronize()
    assert t_wkv.launches == before + 1
    assert out.dtype == dt and state.dtype == torch.float32
    _close(out.float().cpu().numpy(), want_out.float().cpu().numpy(),
           2e-4 if dt == torch.float32 else 2e-2)
    _close(state.cpu().numpy(), want_state.cpu().numpy(), 2e-4)
