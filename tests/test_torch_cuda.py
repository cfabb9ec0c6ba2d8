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


_FA_ROWS_CASES = {
    # B, H, Sq, Sk, D, causal, window, unit rows (XCA), dtype, regime
    "xca_stage2": (16, 4, 24, 24, 1024, False, None, True, torch.float32, "rows"),
    "xca_stage3": (16, 4, 40, 40, 256, False, None, True, torch.float32, "rows"),
    "xca_stage4": (16, 4, 76, 76, 64, False, None, True, torch.float32, "rows"),
    "sk_s_max": (1, 2, 40, 128, 64, False, None, False, torch.float32, "rows"),
    "sk_s_max_plus_1": (1, 2, 40, 129, 64, False, None, False, torch.float32,
                        "online"),
    "masked_rows": (1, 2, 30, 10, 24, True, 4, False, torch.float32, "rows"),
    "bf16_stage2": (16, 4, 24, 24, 1024, False, None, True, torch.bfloat16, "rows"),
    "bf16_stage4": (16, 4, 76, 76, 64, False, None, True, torch.bfloat16, "rows"),
    # the Seamless decoder's first self-attention at prefill: one token
    "decoder_first_token": (4, 16, 1, 1, 64, True, None, False, torch.bfloat16,
                            "rows"),
}


def _fa_inputs(seed, B, H, Sq, Sk, D, unit, dtype):
    q, k, v = _normal(seed, (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D))
    if unit:    # as XCA calls it: rows L2-normalised over D, scale 1
        q = q / q.norm(dim=-1, keepdim=True)
        k = k / k.norm(dim=-1, keepdim=True)
    return [t.to(dtype).contiguous() for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FA_ROWS_CASES))
def test_flash_attention_whole_rows_on_card_matches_plain(case):
    """flash_attention through ``ops`` in the regime ``plan`` picks against
    its plain version: the three XCA shapes at B = 16, Sk = S_MAX and
    S_MAX + 1 (the regime boundary), rows whose every key is masked, and
    bfloat16 at the widest and the longest XCA rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, Sk, D, causal, window, unit, dt, regime = _FA_ROWS_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_fa.plan(B * H, Sq, Sk, D, sms, itemsize=dt.itemsize)["regime"] == regime
    q, k, v = _fa_inputs(29, B, H, Sq, Sk, D, unit, dt)
    kw = dict(causal=causal, window=window, scale=1.0 if unit else None)
    before = t_fa.launches
    got = tops.flash_attention(q, k, v, **kw)
    want = tref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1 and got.dtype == dt
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           2e-4 if dt == torch.float32 else 2e-2)


# the online regime (Sk > 128) at the LM stack's prefill shapes: B, H, Sq,
# Sk, D, causal, window, KV heads (repeated over the query heads), dtype
_FA_ONLINE_CASES = {
    "h2o_4x512": (4, 32, 512, 512, 80, True, None, 8, torch.bfloat16),
    "h2o_window": (1, 8, 700, 700, 80, True, 256, 2, torch.bfloat16),
    "olmo_4x512": (4, 16, 512, 512, 128, True, None, None, torch.bfloat16),
    "minitron_4x512": (2, 24, 512, 512, 128, True, None, 8, torch.bfloat16),
    "f32_ragged_300": (1, 4, 300, 300, 80, True, None, None, torch.float32),
    "f32_d128": (1, 2, 260, 260, 128, True, None, None, torch.float32),
    "f32_d36_noncausal": (1, 4, 256, 256, 36, False, None, None, torch.float32),
    "d256_bf16": (1, 2, 200, 260, 256, True, 50, None, torch.bfloat16),
    "d300_bf16_chunked": (1, 2, 200, 300, 300, True, None, None, torch.bfloat16),
    "f32_d256_chunked": (1, 2, 300, 448, 256, False, None, None, torch.float32),
    "rows_without_keys": (2, 2, 260, 130, 36, True, 7, None, torch.bfloat16),
    # the MoE and encoder-decoder paths: qwen3-moe's 32 query heads over 4
    # KV heads; the Seamless encoder, non-causal at D 64 (1500 frames end in
    # a ragged KV tile of 28 keys); its cross-attention of one decoder token
    # (63 empty rows of the query tile) against 512 and 1500 frames
    "qwen3_gqa_4x512": (4, 32, 512, 512, 128, True, None, 4, torch.bfloat16),
    "encoder_4x512": (4, 16, 512, 512, 64, False, None, None, torch.bfloat16),
    "encoder_1x1500": (1, 16, 1500, 1500, 64, False, None, None, torch.bfloat16),
    "cross_1_to_512": (4, 16, 1, 512, 64, False, None, None, torch.bfloat16),
    "cross_1_to_1500": (1, 16, 1, 1500, 64, False, None, None, torch.bfloat16),
    # RecurrentGemma's local attention: 10 query heads over 1 KV head (MQA)
    # at D 256, causal at a ragged length (700 = 10 x 64 + 60) and under a
    # window shorter than it, and at the served 4 x 512
    "rg_mqa_d256_700": (1, 10, 700, 700, 256, True, None, 1, torch.bfloat16),
    "rg_mqa_d256_700_window": (1, 10, 700, 700, 256, True, 300, 1, torch.bfloat16),
    "rg_mqa_d256_4x512": (4, 10, 512, 512, 256, True, None, 1, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FA_ONLINE_CASES))
def test_flash_attention_online_on_card_matches_plain(case):
    """The online regime (64-row query tiles, 64-key K / V tiles by
    cp.async, both products on the tensor cores) against its plain version
    at the dense path's shapes: causal GQA prompts, a window shorter than
    the prompt, float32 ragged against the tile, D up to 256 in one chunk,
    a wider D over the grid, and rows that see no key; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    B, H, Sq, Sk, D, causal, window, hk, dt = _FA_ONLINE_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_fa.plan(B * H, Sq, Sk, D, sms, itemsize=dt.itemsize)["regime"] == "online"
    hk = hk or H
    q, k, v = _normal(31, (B, H, Sq, D), (B, hk, Sk, D), (B, hk, Sk, D))
    k, v = (t.repeat_interleave(H // hk, dim=1) for t in (k, v))
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    before = t_fa.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1 and got.dtype == dt
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           2e-4 if dt == torch.float32 else 2e-2)
    again = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _fa_launch(q, k, v, out, splits, row_splits, causal=False, window=None):
    """The C entry point in the whole-row regime at a given split."""
    from repro_torch.kernels import flash_attention as t_fa
    B, H, Sq, D = q.shape
    return t_fa._kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), None, B * H, Sq, k.shape[2], D, D ** -0.5,
                          int(causal), int(window is not None), int(window or 0),
                          1, splits, row_splits, 0,
                          torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,splits,row_splits", [
    ((1, 4, 70, 40, 1000), 4, 3),      # 125 column units over 4: 31, 31, 31, 32
    ((1, 4, 70, 100, 1000), 8, 3),     # and over 8, the 5 row tiles over 3
    ((1, 2, 100, 64, 70), 8, 7),       # 9 units over 8, a 16-row tile a block
    ((2, 3, 33, 77, 130), 2, 2),       # D off the unit: the last slice ragged
], ids=["d1000_over_4_rows_3", "d1000_over_8_rows_3", "d70_over_8_rows_7",
        "d130_over_2_rows_2"])
def test_flash_attention_uneven_splits_on_card_match_plain(shape, splits,
                                                           row_splits):
    """The whole-row kernel at splits ``plan`` does not pick: D shared out
    unevenly over the cluster, the query rows split over the grid, a
    causal mask, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Sq, Sk, D = shape
    tiles, units = -(-Sq // 16), -(-D // 8)
    assert t_fa.smem_bytes(16 * -(-tiles // row_splits), Sk,
                           8 * -(-units // splits)) <= t_fa.SMEM_BYTES
    q, k, v = _fa_inputs(30, B, H, Sq, Sk, D, False, torch.float32)
    out = torch.empty_like(q)
    assert _fa_launch(q, k, v, out, splits, row_splits, causal=True) == 0
    want = tref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(out.cpu().numpy(), want.cpu().numpy(), 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 4], ids=["plan", "cluster_of_4"])
def test_flash_attention_is_bitwise_repeatable(splits):
    """The partial scores are summed over the cluster in rank order,
    without atomics: two calls at 64 x 76 x 64 give the same bits, at the
    split ``plan`` picks and with D over a cluster of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    q, k, v = _fa_inputs(31, 16, 4, 76, 76, 64, True, torch.float32)
    if splits is None:
        first = tops.flash_attention(q, k, v, causal=False, scale=1.0)
        second = tops.flash_attention(q, k, v, causal=False, scale=1.0)
    else:
        first, second = torch.empty_like(q), torch.empty_like(q)
        assert _fa_launch(q, k, v, first, splits, 5) == 0
        assert _fa_launch(q, k, v, second, splits, 5) == 0
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# depthwise: (B, H, W, C, fy, fx, (wider C, first channel) or None, dtype)
_DW_CASES = {
    "k3_cv4": (2, 64, 64, 48, 3, 3, None, torch.float32),
    "k5_cv4": (2, 32, 32, 96, 5, 5, None, torch.float32),
    "k7_cv4": (4, 16, 16, 160, 7, 7, None, torch.float32),
    "k9_cv4": (4, 8, 8, 304, 9, 9, None, torch.float32),
    "k3_slice54_cv2": (2, 16, 16, 54, 3, 3, (160, 54), torch.float32),
    "k7_c3_cv1": (2, 9, 7, 3, 7, 7, None, torch.float32),
    "k9_image_under_k": (2, 3, 5, 12, 9, 9, None, torch.float32),
    "generic_4x2": (2, 10, 14, 52, 4, 2, None, torch.float32),
    "generic_11x11": (1, 16, 16, 24, 11, 11, None, torch.float32),
    "generic_1x1_c1": (2, 5, 6, 1, 1, 1, None, torch.float32),
    "bf16_k7": (2, 16, 16, 160, 7, 7, None, torch.bfloat16),
    "bf16_slice54": (2, 16, 16, 54, 3, 3, (160, 54), torch.bfloat16),
    "bf16_slice53_2_bytes": (2, 16, 16, 53, 3, 3, (160, 53), torch.bfloat16),
}


def _dw_inputs(case, seed):
    B, H, W, C, fy, fx, sl, dt = _DW_CASES[case]
    total, start = sl or (C, 0)
    wide, wt, b = _normal(seed, (B, H, W, total), (fy, fx, C), (C,), scale=0.3)
    return wide.to(dt)[..., start:start + C], wt.to(dt), b.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_DW_CASES))
def test_depthwise_every_instance_on_card_matches_plain(case):
    """Each compiled (fy, fx) at CV = 4, 2 and 1, the generic instance
    (even, 1x1 and 11x11 kernels), an image smaller than the kernel, and
    bf16 slices whose start is 4-byte aligned (2-channel copies) or only
    2-byte aligned (one channel a copy), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import depthwise_conv as t_dw
    x, wt, b = _dw_inputs(case, 21)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = t_dw.plan(*x.shape, *wt.shape[:2], sms, itemsize=x.element_size(),
                  align=t_dw.alignment(x, wt, t_dw._pixel_stride(x)))
    if case.startswith("bf16_slice53"):
        assert p["cv"] == 1
    got = tops.depthwise_conv2d(x, wt, b)
    want = tref.depthwise_conv2d_ref(x, wt, b)
    torch.cuda.synchronize()
    tol = 3e-5 if x.dtype == torch.float32 else 2e-2
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), tol)


@pytest.mark.cuda
def test_depthwise_is_bitwise_repeatable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    x, wt, b = _dw_inputs("k7_cv4", 22)
    first = tops.depthwise_conv2d(x, wt, b)
    second = tops.depthwise_conv2d(x, wt, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_depthwise_refuses_a_plan_it_cannot_run():
    """The C entry returns cudaErrorInvalidValue (1) and launches nothing
    for a vector wider than the input's alignment, a tile of more than
    MAX_THREADS threads or a width that is not whole strips; the wrapper
    raises on a refused launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import depthwise_conv as t_dw
    from repro_torch.kernels._launch import check_launch
    x, wt, b = _dw_inputs("k3_slice54_cv2", 23)
    out = torch.empty(x.shape, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(th, tw, cb, cv):
        return t_dw._kernel()(x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                              out.data_ptr(), *x.shape, 160, 3, 3, th, tw, cb,
                              cv, 0, stream)
    assert entry(4, 8, 54, 2) == 0
    assert entry(4, 8, 56, 4) == 1          # 8-byte aligned slice, 16-byte copies
    assert entry(16, 16, 54, 2) == 1        # 27 x 4 x 16 threads
    assert entry(4, 6, 54, 2) == 1          # 6 columns: not whole strips of 4
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="launch failed"):
        check_launch("depthwise_conv2d", entry(4, 8, 56, 4))


# chunked WKV: (bh, T, K, V, chunk, dtype, decay); decay "normal" draws
# logw = -exp(N(0, 0.5^2)) as the JAX tests do, "extreme" -exp(N(2.5, 1))
# (single steps near -40: a chunk's decay passes e^88), "zero" logw = 0,
# "tiny" logw = -1e-6
_WKV_CASES = {
    "served_bf16": (16, 512, 64, 64, 64, torch.bfloat16, "normal"),
    "prompt_200_bf16": (8, 200, 64, 64, 64, torch.bfloat16, "normal"),
    "ragged_c8": (4, 50, 64, 64, 8, torch.float32, "normal"),
    "ragged_c16": (4, 50, 64, 64, 16, torch.float32, "normal"),
    "ragged_c33": (4, 100, 64, 64, 33, torch.float32, "normal"),
    "ragged_c50": (3, 150, 64, 72, 50, torch.float32, "normal"),
    "ragged_c64": (4, 100, 64, 64, 64, torch.float32, "normal"),
    "c128": (4, 300, 64, 64, 128, torch.float32, "normal"),
    "c256": (2, 300, 64, 64, 256, torch.float32, "normal"),
    "k1_v2560": (1, 448, 1, 2560, 64, torch.float32, "normal"),
    "k8_v40": (4, 100, 8, 40, 32, torch.float32, "normal"),
    "extreme_f32": (4, 200, 64, 64, 64, torch.float32, "extreme"),
    "extreme_bf16": (4, 200, 64, 64, 64, torch.bfloat16, "extreme"),
    "zero_decay": (4, 130, 64, 64, 64, torch.float32, "zero"),
    "tiny_decay": (4, 130, 64, 64, 64, torch.float32, "tiny"),
}


def _wkv_inputs(case, seed):
    bh, t, k, v, chunk, dt, decay = _WKV_CASES[case]
    r, kk, vv, w, u = _normal(seed, (bh, t, k), (bh, t, k), (bh, t, v),
                              (bh, t, k), (bh, k), scale=0.5)
    logw = {"normal": lambda: -torch.exp(w),
            "extreme": lambda: -torch.exp(2.5 + 2.0 * w),
            "zero": lambda: torch.zeros_like(w),
            "tiny": lambda: torch.full_like(w, -1e-6)}[decay]()
    return (r.to(dt), kk.to(dt), vv.to(dt), logw, u), chunk


def _wkv_check(out, state, args):
    want_out, want_state = tref.wkv_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and state.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(state).all()
    _close(out.float().cpu().numpy(), want_out.float().cpu().numpy(),
           2e-4 if out.dtype == torch.float32 else 2e-2)
    _close(state.cpu().numpy(), want_state.cpu().numpy(), 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_WKV_CASES))
def test_wkv_chunked_two_passes_on_card_match_plain(case):
    """The states and outputs passes, at the plan's configuration, against
    the per-token ``wkv_ref``: the served and prompt shapes, ragged T at
    chunks 8-256, K = 1 with V = 2560, K = 8 with V = 40, V off the tile,
    and decays at the extremes (finite, within tolerance); one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import rwkv_chunk as t_wkv
    args, chunk = _wkv_inputs(case, 24)
    before = t_wkv.launches
    out, state = tops.wkv_chunked(*args, chunk=chunk)
    assert t_wkv.launches == before + 1
    _wkv_check(out, state, args)


def _wkv_entry(args, chunk, warps, rows, wv=1):
    """The C entry at a given plan; returns (error, out, state)."""
    from repro_torch.kernels import rwkv_chunk as t_wkv
    r, k, v, logw, u = args
    BH, T, K = r.shape
    V = v.shape[2]
    C = min(chunk, T)
    out = torch.empty((BH, T, V), dtype=r.dtype, device=r.device)
    state = torch.empty((BH, K, V), device=r.device)
    ws = t_wkv.workspace(BH, T, K, V, C, r.device)
    codes = [0 if t.dtype == torch.float32 else 1 for t in (r, logw, u)]
    err = t_wkv._kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          logw.data_ptr(), u.data_ptr(), out.data_ptr(),
                          state.data_ptr(), ws.data_ptr(), BH, T, K, V, C,
                          *codes, wv, warps, rows,
                          torch.cuda.current_stream().cuda_stream)
    return err, out, state


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wv,warps,rows", [
    (1, 2, 32), (2, 8, 64), (1, 1, 16), (2, 4, 64), (2, 2, 32), (1, 2, 64),
])
def test_wkv_chunked_every_instance_on_card_matches_plain(dtype, wv, warps,
                                                          rows):
    """Each compiled instance of the outputs pass (one a dtype) with one
    warp and two warps on a tile, a group on several tiles and several
    groups, through the C entry at a ragged shape (T = 150, chunk 50: slabs
    that cut chunks; V = 72 off both V tiles) with bf16 logw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    dt = getattr(torch, dtype)
    r, k, v, _, u = _normal(25, (3, 150, 64), (3, 150, 64), (3, 150, 72),
                            (3, 150, 64), (3, 64), scale=0.5)
    (w,) = _normal(26, (3, 150, 64), scale=0.5)
    args = (r.to(dt), k.to(dt), v.to(dt), (-torch.exp(w)).to(dt), u)
    err, out, state = _wkv_entry(args, 50, warps, rows, wv)
    assert err == 0
    _wkv_check(out, state, args)


@pytest.mark.cuda
def test_wkv_chunked_is_bitwise_repeatable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    args, chunk = _wkv_inputs("extreme_bf16", 27)
    first = tops.wkv_chunked(*args, chunk=chunk)
    second = tops.wkv_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_wkv_chunked_refuses_a_plan_it_cannot_run():
    """The C entry returns cudaErrorInvalidValue (1) for warps a tile it is
    not built for, more groups of warps than tiles, warps that are not
    whole groups, more than 8 warps, and rows that are not whole tiles or
    pass the chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    args, _ = _wkv_inputs("ragged_c64", 28)
    assert _wkv_entry(args, 64, 4, 64)[0] == 0
    assert _wkv_entry(args, 64, 1, 24)[0] == 1
    assert _wkv_entry(args, 64, 2, 16)[0] == 1
    assert _wkv_entry(args, 64, 1, 80)[0] == 1
    assert _wkv_entry(args, 64, 4, 32, 3)[0] == 1
    assert _wkv_entry(args, 64, 3, 64, 2)[0] == 1
    assert _wkv_entry(args, 64, 16, 64, 2)[0] == 1
    assert _wkv_entry(args, 64, 8, 64, 2)[0] == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_ibn", "flash_attention",
                                    "matmul_ln"])
def test_lint_flagged_blocks_are_refused_by_ops_without_a_launch(kernel):
    """The launch lint and the kernels agree: the corpus's off-menu blocks
    on an emitted EdgeNeXt-S entry are a ``lint.block_menu`` finding, and
    the ``ops`` entry point refuses them on CUDA tensors at the entry's
    launch shape before anything launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    import copy
    from repro_torch.check import lint_doc
    from repro_torch.check.mutations import MUTATIONS
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import fused_ibn as t_ibn
    from repro_torch.kernels import matmul_ln as t_mln
    from repro_torch.search import auto_schedule, get_workload, lower
    layers = get_workload("edgenext-s")
    sched = auto_schedule(layers, workload="edgenext-s")
    key, lk = next((k, v) for k, v in sched.lowered.items()
                   if v["kernel"] == kernel)
    s = lower.launch_shape(layers, key, lk)
    module = {"fused_ibn": t_ibn, "flash_attention": t_fa,
              "matmul_ln": t_mln}[kernel]
    for name in ("oversize_block", "non_pow2_block"):
        doc = {"groups": [list(g) for g in sched.groups],
               "lowered": {key: copy.deepcopy(lk)}}
        assert next(m for m in MUTATIONS if m.name == name).apply(doc, layers)
        assert "lint.block_menu" in {f.code for f in lint_doc(doc, layers)}
        blocks = {k: v for k, v in doc["lowered"][key].items()
                  if k.startswith("block_")}
        z = lambda *shape: torch.zeros(shape, device="cuda")  # noqa: E731
        before = module.launches
        with pytest.raises(ValueError, match="built for"):
            if kernel == "fused_ibn":
                tops.fused_ibn(z(s["m"], s["d"]), z(s["d"], s["f"]),
                               z(s["f"], s["do"]), **blocks)
            elif kernel == "matmul_ln":
                tops.matmul_ln(z(s["m"], s["k"]), z(s["k"], s["n"]),
                               z(s["n"]), z(s["n"]), z(s["n"]), **blocks)
            else:
                tops.flash_attention(
                    *[z(1, s["bh"], n, s["d"]) for n in (s["q"], s["k"], s["k"])],
                    causal=False, **blocks)
        torch.cuda.synchronize()
        assert module.launches == before


# ---------------------------------------------------------------------------
# whole steps captured as CUDA graphs (runtime.capture)
# ---------------------------------------------------------------------------


def _counts(*mods):
    torch.cuda.synchronize()
    return [m.launches for m in mods]


@pytest.mark.cuda
def test_captured_edgenext_replays_the_eager_forward_bit_for_bit():
    """The reduced EdgeNeXt at B = 2 captured and replayed on three fresh
    batches: logits equal to the eager forward's bit for bit; the launch
    counters tick at the warm-up runs and the capture, not at a replay; a
    second batch size makes a second graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs run on the "
                    "card only")
    from repro_torch.configs.edgenext_s import reduced_edgenext
    from repro_torch.kernels import depthwise_conv, flash_attention, fused_ibn
    from repro_torch.models import edgenext
    from repro_torch.models.params import init_params
    from repro_torch.runtime.capture import WARMUP, captured

    cfg = reduced_edgenext()
    model = edgenext.EdgeNeXt(cfg, init_params(0, edgenext.param_defs(cfg),
                                               perturb=0.05)).eval()
    mods = (fused_ibn, depthwise_conv, flash_attention)
    per = edgenext.kernel_launches_per_forward(cfg)
    want = [per["fused_ibn"], per["depthwise_conv2d"], per["flash_attention"]]
    images = [_normal(40 + i, (2, 32, 32, 3))[0] for i in range(4)]
    with torch.inference_mode():
        eager = [model(x) for x in images]
    cap = captured(model)
    base = _counts(*mods)
    first = cap(images[0])
    assert [a - b for a, b in zip(_counts(*mods), base)] == [
        (WARMUP + 1) * n for n in want]
    assert torch.equal(first, eager[0])
    base = _counts(*mods)
    for x, e in zip(images[1:], eager[1:]):
        got = cap(x)
        assert torch.equal(got, e)
    assert _counts(*mods) == base and len(cap.graphs) == 1
    one, = _normal(50, (1, 32, 32, 3))
    with torch.inference_mode():
        e1 = model(one)
    assert torch.equal(cap(one), e1) and len(cap.graphs) == 2


@pytest.mark.cuda
def test_captured_rwkv6_prefill_and_donated_decode_replay_the_eager_steps():
    """The reduced RWKV-6 (float32) served through ``launch.serve``'s captured
    steps, prefill and 6 donated decode steps, on three fresh prompts after
    the capture: last hidden, caches, tokens and logits equal to the eager
    steps' bit for bit; wkv_chunked ticks at the prefill's warm-up runs and
    capture only; the decode cache stays in one set of buffers; a second
    (B, T) makes a second graph of each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs run on the "
                    "card only")
    from repro_torch import configs as TC
    from repro_torch.kernels import rwkv_chunk
    from repro_torch.launch import serve
    from repro_torch.models import rwkv6
    from repro_torch.models.params import init_params
    from repro_torch.runtime.capture import WARMUP

    cfg = TC.reduced(TC.get_config("rwkv6-1.6b"))
    params = rwkv6.load_params(cfg, init_params(0, rwkv6.param_defs(cfg)))
    pre_e, dec_e = serve.eager_steps(cfg, params)
    pre_c, dec_c = serve.captured_steps(cfg, params)
    dev = torch.device("cuda")
    rng = np.random.default_rng(60)

    def request(prefill, decode, toks):
        last, cache, _ = serve.run_prefill(prefill, toks)
        out = serve.run_decode(decode, cache, toks.shape[0], 6, dev)
        return [last, *cache, out[0], *out[1], *out[2]]

    held = None
    for i in range(4):
        toks = _t(rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)).cuda()
        eager = request(pre_e, dec_e, toks)
        base = _counts(rwkv_chunk)[0]
        got = request(pre_c, dec_c, toks)
        n = _counts(rwkv_chunk)[0] - base
        assert n == ((WARMUP + 1) * cfg.num_layers if i == 0 else 0)
        assert len(got) == len(eager)
        for a, b in zip(got, eager):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state = got[-4]                     # the last cache's WKV states
        assert held is None or state is held
        held = state
    toks = _t(rng.integers(0, cfg.vocab_size, (1, 17), dtype=np.int32)).cuda()
    for a, b in zip(request(pre_c, dec_c, toks), request(pre_e, dec_e, toks)):
        assert torch.equal(a, b)
    assert len(pre_c.graphs) == 2 and len(dec_c.graphs) == 2


@pytest.mark.cuda
def test_captured_dense_prefill_and_decode_replay_the_eager_steps():
    """The reduced h2o-danube (float32, window 32) served through
    ``launch.serve``'s captured steps: a 40-token prompt (the banded
    prefill, a ring cache) and a 12-token one (a prompt-sized cache that
    decode writes past, each write clamped to its last slot), each with 5
    donated decode steps; last hidden, caches, tokens and logits equal to
    the eager steps' bit for bit; flash_attention ticks at the prefill's
    warm-up runs and capture only, never in decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs run on the "
                    "card only")
    from repro_torch import configs as TC
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.runtime.capture import WARMUP

    cfg = TC.reduced(TC.get_config("h2o-danube-1.8b"))
    params = transformer.load_params(cfg, init_params(0, transformer.param_defs(cfg)))
    pre_e, dec_e = serve.eager_steps(cfg, params)
    pre_c, dec_c = serve.captured_steps(cfg, params)
    dev = torch.device("cuda")
    rng = np.random.default_rng(61)

    def request(prefill, decode, toks):
        last, cache, _ = serve.run_prefill(prefill, toks)
        out = serve.run_decode(decode, cache, toks.shape[0], 5, dev)
        return [last, *cache, out[0], *out[1], *out[2]]

    for S in (40, 12):
        for i in range(2):
            toks = _t(rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)).cuda()
            eager = request(pre_e, dec_e, toks)
            base = t_fa.launches
            got = request(pre_c, dec_c, toks)
            assert t_fa.launches - base == ((WARMUP + 1) * cfg.num_layers
                                            if i == 0 else 0)
            for a, b in zip(got, eager, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(pre_c.graphs) == 2 and len(dec_c.graphs) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-large-v2"])
def test_captured_moe_and_seamless_steps_replay_the_eager_steps(arch):
    """The reduced MoE transformer and encoder-decoder (float32) served
    through ``launch.serve``'s captured steps: two shapes (the encoder-
    decoder's prefill with its decode budget as ``decode_len``), each with 4
    donated decode steps; last hidden, caches, tokens and logits equal to
    the eager steps' bit for bit; flash_attention ticks at the prefill's
    warm-up runs and capture only.  The encoder-decoder's cross K/V are
    the prefill's values after every decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs run on the "
                    "card only")
    from repro_torch import configs as TC
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.launch import serve
    from repro_torch.models import get_module
    from repro_torch.models.params import init_params
    from repro_torch.runtime.capture import WARMUP

    cfg = TC.reduced(TC.get_config(arch))
    mod = get_module(cfg)
    params = mod.load_params(cfg, init_params(0, mod.param_defs(cfg)))
    pre_e, dec_e = serve.eager_steps(cfg, params)
    pre_c, dec_c = serve.captured_steps(cfg, params)
    dev = torch.device("cuda")
    rng = np.random.default_rng(67)
    audio = cfg.family == "audio"

    def request(prefill, decode, toks, embeds):
        last, cache, _ = serve.run_prefill(prefill, toks, embeds,
                                           embeds.shape[1] + 4 if audio else None)
        cross = [t.clone() for t in cache[2:4]] if audio else []
        out = serve.run_decode(decode, cache, toks.shape[0], 4, dev)
        for a, b in zip(cross, out[2][2:4]):
            assert torch.equal(a, b)
        return [last, *cache, out[0], *out[1], *out[2]]

    for S in (40, 70):
        for i in range(2):
            toks = _t(rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)).cuda()
            embeds = _t(rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
                        ).cuda() if audio else None
            toks = toks[:, :1].contiguous() if audio else toks
            eager = request(pre_e, dec_e, toks, embeds)
            base = t_fa.launches
            got = request(pre_c, dec_c, toks, embeds)
            per = mod.kernel_launches_per_prefill(cfg)["flash_attention"]
            assert t_fa.launches - base == ((WARMUP + 1) * per if i == 0 else 0)
            for a, b in zip(got, eager, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(pre_c.graphs) == 2 and len(dec_c.graphs) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [0.1, 1.25])
def test_moe_apply_on_card_matches_the_cpu(capacity_factor):
    """``layers.moe_apply`` on CUDA tensors against the same call on the
    CPU, reduced qwen2-moe (3 experts padded to 4, top 2, one shared
    expert), float32 with TF32 off: equal expert choices, output and aux
    loss within 2e-4; at 0.1 most claims are dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch import configs as TC
    from repro_torch.models import layers as L
    from repro_torch.models.params import from_jax_params, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TC.reduced(TC.get_config("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=3, num_experts_padded=4))
    tree = init_params(5, L.moe_defs(cfg))
    x = np.random.default_rng(6).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = from_jax_params(tree, L.moe_defs(cfg), device=dev)
        xt = _t(x).to(dev)
        y, aux = L.moe_apply(cfg, p, xt, capacity_factor=capacity_factor)
        idx = L.moe_route(cfg, p["router"], xt.reshape(-1, cfg.d_model))[2]
        out[dev] = (y.cpu(), aux.cpu(), idx.cpu())
    assert torch.equal(out["cpu"][2], out["cuda"][2])
    assert (out["cuda"][2] < 3).all()
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        _close(a.numpy(), b.numpy(), 2e-4)


# ---------------------------------------------------------------------------
# the schedule store (serve/) beside a live CUDA context
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_spawned_warm_beside_a_live_context_serves_a_b64_fused_ibn_entry(tmp_path):
    """``ServeStore.warm`` spawns its pool, so it runs while this process
    holds the card's context; a fresh store replays the batch-64 answer
    from disk, verified, and its first ``fused_ibn`` entry launched at its
    true shape with its blocks agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.check import verify_schedule
    from repro_torch.search import get_workload, lower
    from repro_torch.serve import ServeStore
    live = torch.ones(1024, device="cuda")
    assert torch.cuda.is_initialized()
    rep = ServeStore(tmp_path, verify=True).warm(["edgenext-s"],
                                                 batches=(16, 64), jobs=2)
    assert (rep.searched, rep.worker_failed) == (2, 0)
    res = ServeStore(tmp_path, verify=True).request("edgenext-s", 64)
    assert res.outcome == "disk" and not res.degraded
    layers = get_workload(res.workload)
    assert verify_schedule(layers, res.schedule, source="test") == []
    key, lk = next((k, v) for k, v in res.schedule.lowered.items()
                   if v["kernel"] == "fused_ibn")
    s = lower.launch_shape(layers, key, lk)
    assert s["m"] % 64 == 0
    x, = _normal(31, (s["m"], s["d"]))
    w1, = _normal(32, (s["d"], s["f"]), scale=s["d"] ** -0.5)
    w2, = _normal(33, (s["f"], s["do"]), scale=s["f"] ** -0.5)
    blocks = {k: v for k, v in lk.items() if k.startswith("block_")}
    got = tops.fused_ibn(x, w1, w2, **blocks)
    want = tref.fused_ibn_ref(x, w1, w2)
    torch.cuda.synchronize()
    _close(got.cpu().numpy(), want.cpu().numpy(), 3e-5)
    assert live.sum().item() == 1024


# ---------------------------------------------------------------------------
# training: the attention backward, and the kernels that have none
# ---------------------------------------------------------------------------

# (B, H, Sq, Sk, D, causal, window, dtype): the trained shape (h2o-danube's
# 32 heads of 80, bf16, causal), a ragged float32 shape with D over 64 and a
# window, and one of the whole-row forward regime (its lse)
_FA_BWD_CASES = {
    "trained_bf16": (4, 32, 512, 512, 80, True, None, torch.bfloat16),
    "ragged_f32_window": (1, 4, 300, 260, 96, False, 70, torch.float32),
    "rows_regime_f32": (2, 4, 100, 100, 64, True, None, torch.float32),
}


def _fa_bwd_inputs(case, seed):
    B, H, Sq, Sk, D, causal, window, dtype = _FA_BWD_CASES[case]
    q, k, v, dout = _normal(seed, (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D),
                            (B, H, Sq, D))
    return [t.to(dtype) for t in (q, k, v, dout)], dict(causal=causal,
                                                       window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FA_BWD_CASES))
def test_flash_attention_bwd_on_card_matches_plain_autograd(case):
    """``ops.flash_attention`` under autograd on the card (the forward with
    its lse, then the backward kernel, one launch each) against autograd of
    ``ref.attention_ref``: dq, dk and dv within 2e-3 (1 + |b|) in float32,
    the JAX test's tolerance, and 2e-2 in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    (q, k, v, dout), kw = _fa_bwd_inputs(case, 41)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (t_fa.launches, t_fb.launches)
    out = tops.flash_attention(*leaves, **kw)
    assert isinstance(out.grad_fn, t_fa.FlashAttention._backward_cls)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (t_fa.launches, t_fb.launches) == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.attention_ref(*plain, **kw), plain, dout)
    tol = 2e-3 if q.dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g.float().cpu().numpy(), w.float().cpu().numpy(), tol)


@pytest.mark.cuda
def test_flash_attention_bwd_is_bitwise_repeatable():
    """Each of dq, dk, dv is summed by one thread in a fixed order, without
    atomics: two backward calls at the trained shape give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    (q, k, v, dout), kw = _fa_bwd_inputs("trained_bf16", 42)
    out, lse = t_fa.flash_attention(q, k, v, return_lse=True, **kw)
    first = t_fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = t_fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_served_forward_writes_no_lse(monkeypatch):
    """The C entry gets a null lse from a call with no gradient asked for
    (no grad mode, or no input requiring grad) and an lse buffer only under
    autograd; the output is the same either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    real, seen = t_fa._kernel(), []

    def recording(*args):
        seen.append(args[4])
        return real(*args)

    monkeypatch.setattr(t_fa, "_kernel", lambda: recording)
    (q, k, v, _), kw = _fa_bwd_inputs("rows_regime_f32", 43)
    with torch.inference_mode():
        served = tops.flash_attention(q, k, v, **kw)
    no_grad_input = tops.flash_attention(q, k, v, **kw)
    trained = tops.flash_attention(q.clone().requires_grad_(), k, v, **kw)
    torch.cuda.synchronize()
    assert seen[0] is None and seen[1] is None and isinstance(seen[2], int)
    assert torch.equal(served, no_grad_input)
    assert torch.equal(served, trained.detach())


def _refusal_inputs(kernel):
    if kernel == "fused_ibn":
        return tops.fused_ibn, _normal(44, (64, 48), (48, 160), (160, 48))
    if kernel == "matmul_ln":
        return tops.matmul_ln, _normal(45, (64, 96), (96, 96), (96,), (96,), (96,))
    if kernel == "depthwise_conv2d":
        return tops.depthwise_conv2d, _normal(46, (1, 8, 8, 16), (3, 3, 16), (16,))
    r, k, v, w, u = _normal(47, (4, 32, 16), (4, 32, 16), (4, 32, 16),
                            (4, 32, 16), (4, 16))
    return (lambda *a: tops.wkv_chunked(*a, chunk=16)), [r, k, v, -torch.exp(w), u]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_ibn", "matmul_ln",
                                    "depthwise_conv2d", "wkv_chunked"])
def test_kernels_without_a_backward_refuse_a_gradient_on_card(kernel):
    """A CUDA input (a weight here) that requires grad under grad mode: the
    entry raises, naming the kernel, before anything launches (the counter
    does not move); under no_grad the same call launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    import importlib
    mod = importlib.import_module("repro_torch.kernels." + {
        "fused_ibn": "fused_ibn", "matmul_ln": "matmul_ln",
        "depthwise_conv2d": "depthwise_conv", "wkv_chunked": "rwkv_chunk"}[kernel])
    fn, args = _refusal_inputs(kernel)
    args[1].requires_grad_()
    before = mod.launches
    with pytest.raises(RuntimeError, match=kernel):
        fn(*args)
    torch.cuda.synchronize()
    assert mod.launches == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
