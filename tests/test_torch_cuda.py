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
    # starcoder2-15b's 48 query heads over 4 KV heads (G 12) and
    # qwen2-vl-2b's 12 over 2, D 128, at the served 4 x 512
    "starcoder2_4x512": (4, 48, 512, 512, 128, True, None, 4, torch.bfloat16),
    "qwen2vl_4x512": (4, 12, 512, 512, 128, True, None, 2, torch.bfloat16),
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
                          0, 1, splits, row_splits, 0,
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
                          logw.data_ptr(), u.data_ptr(), None, out.data_ptr(),
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
@pytest.mark.parametrize("arch", ["starcoder2-15b", "minitron-4b", "olmo-1b",
                                  "qwen2-vl-2b", "qwen3-moe-30b-a3b"])
def test_captured_steps_on_weights_drawn_on_card_replay_eager_and_hold_to_plain(arch):
    """The reduced config in bfloat16, its weights drawn on the card
    (``init_on_device``), served through ``launch.serve``'s captured steps
    at two shapes (qwen2-vl with ``inputs_embeds`` and image-then-text
    M-RoPE positions), each with 5 donated decode steps: last hidden,
    caches, tokens and logits equal to the eager steps' bit for bit,
    flash_attention ticking at the capture only; the eager run held to the
    plain model teacher-forced, as ``chip_smoke.py`` holds the served LMs:
    logits within 0.25, at least 75 % of the greedy tokens agreeing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs run on the "
                    "card only")
    import dataclasses
    from repro_torch import configs as TC
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.runtime import build_decode_step, build_prefill_step
    from repro_torch.runtime.capture import WARMUP

    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)), dtype="bfloat16")
    params = transformer.load_params(cfg, transformer.init_on_device(cfg, 0))
    assert params["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    pre_e, dec_e = serve.eager_steps(cfg, params)
    pre_c, dec_c = serve.captured_steps(cfg, params)
    plain_pre = build_prefill_step(cfg, kernels=tref.PLAIN)
    plain_dec = build_decode_step(cfg, kernels=tref.PLAIN)
    dev = torch.device("cuda")
    rng = np.random.default_rng(71)
    err, agree, steps = 0.0, 0, 0
    for S in (40, 20):
        for i in range(2):
            toks = _t(rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)).cuda()
            batch = {"tokens": toks}
            if cfg.embedding_inputs:
                batch["inputs_embeds"] = _t(rng.standard_normal(
                    (2, S, cfg.d_model)).astype(np.float32)).cuda()
                batch["positions"] = L.image_text_positions(
                    2, S, 4 if S == 40 else 2, "cuda")

            def request(prefill, decode):
                last, cache, _ = serve.run_prefill(
                    prefill, toks, batch.get("inputs_embeds"),
                    positions=batch.get("positions"))
                out = serve.run_decode(decode, cache, 2, 5, dev)
                return [last, *cache, out[0], *out[1], *out[2]]

            eager = request(pre_e, dec_e)
            base = t_fa.launches
            got = request(pre_c, dec_c)
            assert t_fa.launches - base == ((WARMUP + 1) * cfg.num_layers
                                            if i == 0 else 0)
            for a, b in zip(got, eager, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
            # the plain model fed the eager run's tokens: ``eager`` is last,
            # the prefill cache (k, v, step), tokens, 5 logits, last cache
            toks_out = eager[4]
            logits = torch.stack(eager[5:10], 1)
            with torch.inference_mode():
                _, cache = plain_pre(params, batch)
                forced = torch.cat([torch.zeros_like(toks_out[:, :1]),
                                    toks_out[:, :-1]], 1)
                plain = []
                for j in range(5):
                    _, lg, cache = plain_dec(params, cache,
                                             {"tokens": forced[:, j:j + 1]})
                    plain.append(lg)
            plain = torch.stack(plain, 1)
            V = cfg.vocab_size
            err = max(err, (logits[..., :V] - plain[..., :V]).abs().max().item())
            agree += int((plain[..., :V].argmax(-1) == toks_out).sum())
            steps += toks_out.numel()
    assert len(pre_c.graphs) == 2 and len(dec_c.graphs) == 2
    assert err <= 0.25 and agree >= 0.75 * steps, (err, agree, steps)


@pytest.mark.cuda
def test_init_on_device_repeats_bit_for_bit_on_card():
    """Two draws of one seed on the card give the same bits; ``layers=1``
    is the first slice of the float32 draw and the bfloat16 leaves are that
    draw rounded; the leaves are made on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch import configs as TC
    from repro_torch.models import transformer
    from repro_torch.models.params import cast_paths, tree_map

    cfg = TC.reduced(TC.get_config("qwen3-moe-30b-a3b"))
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    cast = cast_paths(cfg, transformer.COMPUTE_DTYPE_LEAVES)

    def leaves(tree):
        out = {}
        tree_map(lambda t, path: out.__setitem__(path, t), tree)
        return out

    a, b = (leaves(transformer.init_on_device(bf16, 5)) for _ in range(2))
    f32 = leaves(transformer.init_on_device(cfg, 5))
    one = leaves(transformer.init_on_device(cfg, 5, layers=1))
    for path, t in a.items():
        assert t.is_cuda and torch.equal(t, b[path]), path
        want = f32[path].to(torch.bfloat16) if path in cast else f32[path]
        assert t.dtype == want.dtype and torch.equal(t, want), path
        first = f32[path][:1] if path.startswith("blocks.") else f32[path]
        assert torch.equal(one[path], first), path


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
# window, and one of the whole-row forward regime (its lse); then the edges
# of the ring and of the 128-key dK / dV blocks (flash_attention_bwd.PLAN):
# Sq and Sk not multiples of 128 under `causal` (bf16 D 80), olmo-1b's bf16
# D 128, RecurrentGemma's bf16 D 256 (two output chunks) under a window with
# one KV head repeated over ten, Seamless's non-causal cross shape 256 ->
# 512, and a window under which rows past Sk + window - 1 see no key
_FA_BWD_CASES = {
    "trained_bf16": (4, 32, 512, 512, 80, True, None, torch.bfloat16),
    "ragged_f32_window": (1, 4, 300, 260, 96, False, 70, torch.float32),
    "rows_regime_f32": (2, 4, 100, 100, 64, True, None, torch.float32),
    "ragged_causal_bf16_d80": (2, 4, 333, 290, 80, True, None, torch.bfloat16),
    "olmo_bf16_d128": (2, 16, 512, 512, 128, True, None, torch.bfloat16),
    "mqa_window_bf16_d256": (1, 10, 512, 512, 256, True, 200, torch.bfloat16),
    "cross_bf16_256_to_512": (4, 16, 256, 512, 64, False, None, torch.bfloat16),
    "window_rows_with_no_key": (1, 2, 200, 100, 64, True, 30, torch.float32),
    # the shapes phase 5l of chip_smoke.py trains: Seamless's encoder and
    # cross-attention (non-causal) and decoder (causal) at 4 x 16 x 512 -> 512,
    # D 64; RecurrentGemma's MQA D 256 under its window of 2048; qwen2-moe's
    # MHA D 128; then the reduced configs' float32 D 16 (train_multiarch: 4 x
    # 48 tokens, the whole-row forward regime), causal, non-causal and under
    # the reduced window of 32
    "seamless_noncausal_bf16_d64": (4, 16, 512, 512, 64, False, None, torch.bfloat16),
    "seamless_causal_bf16_d64": (4, 16, 512, 512, 64, True, None, torch.bfloat16),
    "rg_trained_bf16_d256": (4, 10, 512, 512, 256, True, 2048, torch.bfloat16),
    "moe_trained_bf16_d128": (4, 16, 512, 512, 128, True, None, torch.bfloat16),
    "reduced_f32_d16": (4, 4, 48, 48, 16, True, None, torch.float32),
    "reduced_f32_d16_noncausal": (4, 4, 48, 48, 16, False, None, torch.float32),
    "reduced_f32_d16_window": (4, 4, 48, 48, 16, True, 32, torch.float32),
}
# cases whose K and V are made on fewer heads and repeated over the query
# heads' groups, as the models hand them over
_FA_BWD_KV_HEADS = {"mqa_window_bf16_d256": 1, "rg_trained_bf16_d256": 1,
                    "reduced_f32_d16": 2}
# cases with rows that see no key: there the reference's formulas (P = 1 on
# the masked keys, `_flash_bwd`) are not the softmax's derivative, so the
# kernel is held to ``ref.attention_bwd_ref`` (which the CPU tests hold to
# `_flash_bwd`) given the plain forward's out and lse
_FA_BWD_EMPTY_ROWS = {"window_rows_with_no_key"}


def _fa_bwd_inputs(case, seed):
    B, H, Sq, Sk, D, causal, window, dtype = _FA_BWD_CASES[case]
    hk = _FA_BWD_KV_HEADS.get(case, H)
    q, k, v, dout = _normal(seed, (B, H, Sq, D), (B, hk, Sk, D), (B, hk, Sk, D),
                            (B, H, Sq, D))
    k, v = (t.repeat_interleave(H // hk, dim=1) for t in (k, v))
    return [t.to(dtype) for t in (q, k, v, dout)], dict(causal=causal,
                                                       window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FA_BWD_CASES))
def test_flash_attention_bwd_on_card_matches_plain_autograd(case):
    """``ops.flash_attention`` under autograd on the card (the forward with
    its lse, then the backward kernel, one launch each) against autograd of
    ``ref.attention_ref``: dq, dk and dv within 2e-3 (1 + |b|) in float32,
    the JAX test's tolerance, and 2e-2 in bf16.  Where some row sees no
    key, against the reference's formulas (``ref.attention_bwd_ref``)."""
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
    if case in _FA_BWD_EMPTY_ROWS:
        out_r, lse_r = tref.attention_fwd_lse_ref(q, k, v, **kw)
        want = tref.attention_bwd_ref(q, k, v, out_r, lse_r, dout, **kw)
    else:
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
def test_flash_attention_bwd_is_bitwise_repeatable_at_d128():
    """The same at olmo-1b's bf16 D 128, whose dK / dV blocks hold 128 keys
    over a ring of (q, dO) tiles: two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    (q, k, v, dout), kw = _fa_bwd_inputs("olmo_bf16_d128", 48)
    out, lse = t_fa.flash_attention(q, k, v, return_lse=True, **kw)
    first = t_fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = t_fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_moe_layer_forward_and_backward_repeat_bit_for_bit():
    """One ``layers.moe_apply`` at qwen2-moe's width (d 2048, 60 experts
    padded to 64, top 4, 4 shared experts), 4 x 512 tokens in bf16 with its
    matrices cast to bf16 as the train step casts them, capacity factor
    1.25 (some claims dropped): the output, the aux loss and the gradients
    of sum(out * w) + aux with respect to x and every leaf, twice on the
    same inputs, bit for bit.  The backward sums each token's k copies and
    each expert row's gradient on the card; this shows those sums are taken
    in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import configs as TC
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_on_device, tree_leaves, tree_map

    cfg = TC.get_config("qwen2-moe-a2.7b")
    tree = tree_map(lambda t, path: t.to(torch.bfloat16) if t.dim() >= 2 else t,
                    init_on_device(3, L.moe_defs(cfg)))
    x, w = _normal(61, (4, 512, cfg.d_model), (4, 512, cfg.d_model))
    x = x.to(torch.bfloat16)

    def once():
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
        it = iter(leaves)
        p = tree_map(lambda t, path: next(it), tree)
        xt = x.detach().requires_grad_()
        out, aux = L.moe_apply(cfg, p, xt, capacity_factor=1.25)
        loss = torch.sum(out.float() * w) + aux
        return [out.detach(), aux.detach()] + list(
            torch.autograd.grad(loss, [xt] + leaves))

    first, second = once(), once()
    torch.cuda.synchronize()
    names = ["out", "aux", "x"]
    tree_map(lambda t, path: names.append(path), tree)
    assert len(first) == len(names)
    assert torch.isfinite(first[0].float()).all()
    for n, a, b in zip(names, first, second):
        assert torch.equal(a, b), n


def _sharded_moe_rank():
    from repro_torch import configs as TC
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers as L
    from repro_torch.models import moe_sharded
    from repro_torch.models.params import init_on_device, tree_leaves, tree_map
    cfg = TC.get_config("qwen2-moe-a2.7b")
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    tree = tree_map(lambda t, path: t.to(torch.bfloat16) if t.dim() >= 2 else t,
                    init_on_device(3, L.moe_defs(cfg)))
    x, w = _normal(61, (4, 512, cfg.d_model), (4, 512, cfg.d_model))
    x = x.to(torch.bfloat16)

    def once():
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
        it = iter(leaves)
        p = tree_map(lambda t, path: next(it), tree)
        xt = x.detach().requires_grad_()
        out, aux = moe_sharded.moe_apply_sharded(cfg, p, xt, mesh=mesh,
                                                 capacity_factor=1.25)
        loss = torch.sum(out.float() * w) + aux
        return [out.detach(), aux.detach()] + list(
            torch.autograd.grad(loss, [xt] + leaves))

    first, second = once(), once()
    torch.cuda.synchronize()
    names = ["out", "aux", "x"]
    tree_map(lambda t, path: names.append(path), tree)
    return (names, [torch.equal(a, b) for a, b in zip(first, second)],
            bool(torch.isfinite(first[0].float()).all()))


@pytest.mark.cuda
def test_sharded_moe_forward_and_backward_repeat_bit_for_bit():
    """``moe_sharded.moe_apply_sharded`` in a gloo world of two ranks sharing
    the card, (data 1, model 2): each rank 32 of qwen2-moe's 64 padded
    experts and half of the shared experts' ff, every token on both ranks
    (4 x 512, bf16, the matrices cast to bf16, capacity factor 1.25: some
    claims dropped).  Forward and backward twice on each rank: the output,
    the aux loss and the gradients of sum(out * w) + aux with respect to x
    and every leaf, bit for bit.  The combine clamps a claim off the rank
    to the rank's last slot and zeroes it; this shows that the gather's
    backward there receives only exact zeros, and that the index sums and
    the sum over 'model' are taken in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn_local(2, _sharded_moe_rank, device="cuda", timeout_s=300)
    for names, same, finite in ranks:
        assert finite
        assert len(names) == len(same)
        assert [n for n, s in zip(names, same) if not s] == []


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
    does not move); under no_grad the same call launches once.
    ``wkv_chunked`` has had a backward since item 7c: the same call returns
    outputs with ``WKVChunked``'s ``grad_fn`` after one launch."""
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
    if kernel == "wkv_chunked":
        out, state = fn(*args)
        torch.cuda.synchronize()
        assert isinstance(out.grad_fn, mod.WKVChunked._backward_cls)
        assert state.grad_fn is out.grad_fn
        assert mod.launches == before + 1
        return
    with pytest.raises(RuntimeError, match=kernel):
        fn(*args)
    torch.cuda.synchronize()
    assert mod.launches == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1


# (BH, T, K, V, chunk, dtype, decay, with dS_T): RWKV-6's trained shape
# (4 x 32 heads of 64, T 512, chunk 64, bf16 r/k/v/dout, float32 logw and
# u), the B = 1 x 200 prompt (ragged at chunk 64), the extreme decays in
# float32 and bf16, a nonzero cotangent of the final state, chunk 128 (the
# tile instance of ``rwkv_chunk_bwd.plan``; the others take the chunk
# instance), the reduced configs' chunk 8 at K = V = 16, and a ragged
# width, K = V = 40 at T = 130
_WKV_BWD_CASES = {
    "trained_bf16": (128, 512, 64, 64, 64, torch.bfloat16, "normal", False),
    "ragged_1x200": (32, 200, 64, 64, 64, torch.float32, "normal", False),
    "extreme_f32": (4, 200, 64, 64, 64, torch.float32, "extreme", False),
    "extreme_bf16": (4, 200, 64, 64, 64, torch.bfloat16, "extreme", False),
    "dstate_f32": (4, 130, 64, 64, 32, torch.float32, "normal", True),
    "chunk128_tiles": (4, 300, 64, 64, 128, torch.float32, "normal", True),
    "chunk8_k16": (16, 100, 16, 16, 8, torch.float32, "normal", True),
    "ragged_width_40": (4, 130, 40, 40, 64, torch.float32, "normal", True),
}


def _wkv_bwd_inputs(case, seed):
    BH, T, K, V, chunk, dt, decay, with_ds = _WKV_BWD_CASES[case]
    r, k, v, w, u, dout, ds = _normal(seed, (BH, T, K), (BH, T, K), (BH, T, V),
                                      (BH, T, K), (BH, K), (BH, T, V), (BH, K, V))
    r, k, v, u = (t * 0.5 for t in (r, k, v, u))
    logw = -torch.exp(0.5 * w) if decay == "normal" else -torch.exp(2.5 + w)
    return ((r.to(dt), k.to(dt), v.to(dt), logw, u), dout.to(dt),
            ds if with_ds else None, chunk, decay)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_WKV_BWD_CASES))
def test_wkv_chunked_bwd_on_card_matches_plain_autograd(case):
    """``ops.wkv_chunked`` under autograd on the card (the forward kernel,
    whose workspace the backward reads, then the backward kernel, one
    launch each) against autograd of ``ref.wkv_ref``: dr, dk, dv, dlogw
    and du within 2e-4 (1 + |b|) in float32 and 1e-3 at the extreme decays
    (the float32 cumsum reaches a thousand or more within a chunk, so every
    exponent keeps less absolute precision); in bf16, 2e-2 on dr, dk, dv and
    a relative L2 error of 2e-4 on the float32 dlogw and du."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import rwkv_chunk as t_wkv
    from repro_torch.kernels import rwkv_chunk_bwd as t_bwd
    args, dout, ds, chunk, decay = _wkv_bwd_inputs(case, 61)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (t_wkv.launches, t_bwd.launches)
    out, state = tops.wkv_chunked(*leaves, chunk=chunk)
    assert isinstance(out.grad_fn, t_wkv.WKVChunked._backward_cls)
    got = torch.autograd.grad((out, state) if ds is not None else (out,), leaves,
                              (dout, ds) if ds is not None else (dout,))
    torch.cuda.synchronize()
    assert (t_wkv.launches, t_bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in args]
    p_out, p_state = tref.wkv_ref(*plain)
    want = torch.autograd.grad((p_out, p_state) if ds is not None else (p_out,),
                               plain, (dout, ds) if ds is not None else (dout,))
    tol = 1e-3 if decay == "extreme" else 2e-4
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all(), name
        if g.dtype == torch.bfloat16:
            _close(g.float().cpu().numpy(), w.float().cpu().numpy(), 2e-2)
        elif args[0].dtype == torch.bfloat16:
            rel = ((g - w).norm() / w.norm()).item()
            assert rel <= 2e-4, (name, rel)
        else:
            _close(g.cpu().numpy(), w.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case,instance", [("trained_bf16", "chunk"),
                                           ("chunk128_tiles", "tiles")])
def test_wkv_chunked_bwd_is_bitwise_repeatable(case, instance):
    """Every sum of the backward runs in a fixed order, without atomics: two
    calls with a nonzero dS_T give the same bits, on each instance of
    ``rwkv_chunk_bwd.plan`` (the trained shape: one block a chunk; chunk
    128: one block a tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import rwkv_chunk as t_wkv
    from repro_torch.kernels import rwkv_chunk_bwd as t_bwd
    args, dout, _, chunk, _ = _wkv_bwd_inputs(case, 62)
    BH, T, K = args[0].shape
    assert t_bwd.plan(min(chunk, T), K, args[2].shape[2],
                      args[0].element_size())["instance"] == instance
    ds = _normal(63, (BH, K, args[2].shape[2]))[0]
    _, state, ws = t_wkv.forward_with_states(*args, chunk=chunk)
    first = t_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk, dstate=ds,
                                  state=state)
    second = t_bwd.wkv_chunked_bwd(*args, dout, ws, chunk=chunk, dstate=ds,
                                   state=state)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------------------------------
# a sequence shard: attention at a query offset, the WKV from a given state
# ---------------------------------------------------------------------------

# B, H, KV heads, the rank's queries, keys, D, causal, window, q_offset,
# dtype: the online regime at RecurrentGemma's 1 x 4608 split in two (MQA,
# D 256, its window of 2048 crossing the shard's edge) and at a ragged
# float32 shard whose window crosses the edge, the whole-row regime (Sk <=
# 128) with the window across the edge, and a non-causal window at an
# offset
_OFFSET_CASES = {
    "rg_split_bf16_d256": (1, 10, 1, 2304, 4608, 256, True, 2048, 2304, torch.bfloat16),
    "online_ragged_f32_window": (2, 4, 4, 150, 350, 80, True, 64, 200, torch.float32),
    "rows_regime_f32_window": (2, 4, 4, 40, 100, 64, True, 30, 60, torch.float32),
    "noncausal_window_f32": (1, 2, 2, 100, 300, 64, False, 50, 120, torch.float32),
}


def _offset_inputs(case, seed):
    B, H, hk, Sq, Sk, D, causal, window, o, dtype = _OFFSET_CASES[case]
    q, k, v, dout = _normal(seed, (B, H, Sq, D), (B, hk, Sk, D), (B, hk, Sk, D),
                            (B, H, Sq, D))
    k, v = (t.repeat_interleave(H // hk, dim=1) for t in (k, v))
    return [t.to(dtype) for t in (q, k, v, dout)], dict(causal=causal, window=window,
                                                       q_offset=o)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_OFFSET_CASES))
def test_flash_attention_at_a_query_offset_on_card_matches_plain(case):
    """The forward kernel (both regimes: ``flash_attention.plan`` picks the
    whole rows where Sk <= 128) and, under autograd, the backward kernel
    with ``q_offset``, against ``ref.attention_ref`` at the same offset and
    its autograd: the output within 2e-4 (1 + |b|) in float32 and 2e-2 in
    bf16, dq, dk, dv within 2e-3 and 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    (q, k, v, dout), kw = _offset_inputs(case, 81)
    B, H, Sq, D = q.shape
    regime = t_fa.plan(B * H, Sq, k.shape[2], D,
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       itemsize=q.element_size())["regime"]
    assert regime == ("rows" if case.startswith("rows") else "online")
    f32 = q.dtype == torch.float32
    with torch.no_grad():
        got = tops.flash_attention(q, k, v, **kw)
    _close(got.float().cpu().numpy(), tref.attention_ref(q, k, v, **kw).float().cpu().numpy(),
           2e-4 if f32 else 2e-2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (t_fa.launches, t_fb.launches)
    grads = torch.autograd.grad(tops.flash_attention(*leaves, **kw), leaves, dout)
    torch.cuda.synchronize()
    assert (t_fa.launches, t_fb.launches) == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.attention_ref(*plain, **kw), plain, dout)
    for g, w in zip(grads, want):
        _close(g.float().cpu().numpy(), w.float().cpu().numpy(), 2e-3 if f32 else 2e-2)


@pytest.mark.cuda
def test_offset_zero_and_no_state_give_the_bits_of_a_call_without_them():
    """``q_offset=0`` gives the bits of a call that does not pass it (the
    forward in both regimes, its lse, the backward), and ``state=None`` those
    of a WKV call without a state, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    from repro_torch.kernels import rwkv_chunk as t_wkv
    from repro_torch.kernels import rwkv_chunk_bwd as t_bwd
    for case in ("rows_regime_f32_window", "online_ragged_f32_window"):
        (q, k, v, dout), kw = _offset_inputs(case, 82)
        kw.pop("q_offset")
        a = t_fa.flash_attention(q, k, v, return_lse=True, **kw)
        b = t_fa.flash_attention(q, k, v, return_lse=True, q_offset=0, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case
        ga = t_fb.flash_attention_bwd(q, k, v, *a, dout, **kw)
        gb = t_fb.flash_attention_bwd(q, k, v, *a, dout, q_offset=0, **kw)
        assert all(torch.equal(x, y) for x, y in zip(ga, gb)), case
    args, dout, _, chunk, _ = _wkv_bwd_inputs("trained_bf16", 83)
    a = t_wkv.forward_with_states(*args, chunk=chunk)
    b = t_wkv.forward_with_states(*args, chunk=chunk, state=None)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ga = t_bwd.wkv_chunked_bwd(*args, dout, a[2], chunk=chunk)
    gb = t_bwd.wkv_chunked_bwd(*args, dout, b[2], chunk=chunk, ds0=False)
    assert len(ga) == 5 and all(torch.equal(x, y) for x, y in zip(ga, gb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["trained_bf16", "ragged_1x200", "dstate_f32",
                                  "chunk128_tiles"])
def test_wkv_chunked_from_a_state_on_card_matches_plain(case):
    """The WKV forward and backward kernels from a nonzero initial state
    (the state a sequence shard receives), under autograd, against
    ``ref.wkv_ref`` from the same state and its autograd: the output and
    the final state as ``test_wkv_chunked_on_card_matches_plain`` holds
    them, dr, dk, dv, dlogw, du and dS0 as
    ``test_wkv_chunked_bwd_on_card_matches_plain_autograd`` holds the
    gradients (dS0 float32: 2e-4, relative L2 2e-4 in a bf16 run), on the
    chunk instance and the tile instance (chunk 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs on the "
                    "card only")
    from repro_torch.kernels import rwkv_chunk as t_wkv
    from repro_torch.kernels import rwkv_chunk_bwd as t_bwd
    args, dout, ds, chunk, _ = _wkv_bwd_inputs(case, 84)
    BH, T, K = args[0].shape
    s0 = _normal(85, (BH, K, args[2].shape[2]), scale=0.5)[0]
    bf = args[0].dtype == torch.bfloat16
    leaves = [t.clone().requires_grad_() for t in (*args, s0)]
    before = (t_wkv.launches, t_bwd.launches)
    out, state = tops.wkv_chunked(*leaves[:5], chunk=chunk, state=leaves[5])
    outs, cots = ((out, state), (dout, ds)) if ds is not None else ((out,), (dout,))
    got = torch.autograd.grad(outs, leaves, cots)
    torch.cuda.synchronize()
    assert (t_wkv.launches, t_bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (*args, s0)]
    p_out, p_state = tref.wkv_ref(*plain[:5], plain[5])
    _close(out.detach().float().cpu().numpy(), p_out.detach().float().cpu().numpy(),
           2e-2 if bf else 2e-4)
    _close(state.detach().cpu().numpy(), p_state.detach().cpu().numpy(), 2e-4)
    want = torch.autograd.grad((p_out, p_state) if ds is not None else (p_out,), plain,
                               cots)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all(), name
        if g.dtype == torch.bfloat16:
            _close(g.float().cpu().numpy(), w.float().cpu().numpy(), 2e-2)
        elif bf:
            rel = ((g - w).norm() / w.norm()).item()
            assert rel <= 2e-4, (name, rel)
        else:
            _close(g.cpu().numpy(), w.cpu().numpy(), 2e-4)


# ---------------------------------------------------------------------------
# the distributed runtime on the card
# ---------------------------------------------------------------------------


def _collectives_rank():
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import collectives as C
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    r = mesh.coords["model"]
    out = {}
    for dev in ("cuda", "cpu"):
        x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * r
        before = C.host_staged_bytes
        got = [C.psum(x, mesh, "model"), C.all_gather(x, mesh, "model", 1),
               C.ppermute(x, mesh, "model", [(0, 1), (1, 0)])]
        out[dev] = ([t.cpu().numpy() for t in got], [t.device.type for t in got],
                    C.host_staged_bytes - before)
    return out


@pytest.mark.cuda
def test_collectives_of_cuda_tensors_in_a_gloo_world_on_one_card():
    """Two ranks share the card under gloo: ``psum``, ``all_gather`` and
    ``ppermute`` of CUDA tensors give the CPU tensors' results, stay on
    the card, and count their copies through the host (24 bytes a rank's
    tensor, each way; the all-gather brings back both ranks' 48)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn_local(2, _collectives_rank, device="cuda", timeout_s=120)
    for r in ranks:
        (cuda_vals, cuda_devs, cuda_staged), (cpu_vals, _, cpu_staged) = r["cuda"], r["cpu"]
        for a, b in zip(cuda_vals, cpu_vals):
            np.testing.assert_array_equal(a, b)
        assert cuda_devs == ["cuda"] * 3
        assert cpu_staged == 0 and cuda_staged == (24 + 24) + (24 + 48) + (24 + 24)


def _one_by_one_nccl_rank():
    from repro_torch import configs as TC
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_module
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.optim import adamw_init, warmup_cosine
    from repro_torch.runtime import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TC.reduced(TC.get_config("h2o-danube-1.8b"))
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    tree = init_params(1, get_module(cfg).param_defs(cfg))
    ds = make_dataset(cfg, TC.ShapeConfig("train_4k", "train", 64, 4), seed=3)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
               for s in range(3)]
    runs = []
    for m in (mesh, None):
        step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=m)
        params = tree_map(lambda a, path: torch.from_numpy(a.copy()).cuda()
                          .requires_grad_(), tree)
        opt = adamw_init(params)
        metrics = []
        for b in batches:
            params, opt, mt = step(params, opt, b)
            metrics.append(torch.stack([mt[k] for k in ("loss", "ce", "aux", "grad_norm")]))
        runs.append((torch.stack(metrics), tree_leaves(params) + tree_leaves(opt.m)
                     + tree_leaves(opt.v)))
    (ma, sa), (mb, sb) = runs
    return mesh.backend, torch.equal(ma, mb) and all(torch.equal(a, b)
                                                     for a, b in zip(sa, sb))


@pytest.mark.cuda
def test_one_by_one_nccl_train_step_changes_no_bit():
    """A world of one rank under NCCL: the (1, 1) mesh's train step gives
    the no-mesh step bit for bit on the card (three steps of h2o-danube
    reduced: metrics, parameters, both moments)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.launch import mesh as mesh_lib
    assert mesh_lib.spawn_local(1, _one_by_one_nccl_rank, device="cuda",
                                timeout_s=240) == [("nccl", True)]


def _tp_pair_rank():
    from repro_torch import configs as TC
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_module
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.optim import adamw_init, warmup_cosine
    from repro_torch.runtime import build_train_step, sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TC.reduced(TC.get_config("h2o-danube-1.8b"))
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    tree = init_params(1, get_module(cfg).param_defs(cfg))
    ds = make_dataset(cfg, TC.ShapeConfig("train_4k", "train", 64, 4), seed=3)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
               for s in range(3)]
    runs = {}
    for name, m in (("one", None), ("tp", mesh)):
        step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=m,
                                profile="tp")
        specs = step.pspecs if m is not None else tree_map(lambda a, path: None, tree)
        params = tree_map(lambda a, s, path: torch.from_numpy(np.array(
            a if s is None else sharding.local_shard(a, s, mesh))).cuda()
            .requires_grad_(), tree, specs)
        opt = adamw_init(params)
        losses, launches = [], []
        for b in batches:
            before = fa_mod.launches
            params, opt, mt = step(params, opt, b)
            losses.append(float(mt["loss"]))
            launches.append(fa_mod.launches - before)
        if m is not None:
            params = sharding.tree_gather_full(params, step.pspecs, mesh)
        runs[name] = (losses, launches, {k: v.detach().cpu().numpy() for k, v in
                                         zip(_paths(params), _leaves(params))})
    return runs


def _paths(tree):
    from repro_torch.models.params import tree_map
    out = []
    tree_map(lambda t, path: out.append(path), tree)
    return out


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree)


@pytest.mark.cuda
def test_tensor_parallel_train_step_on_one_card_holds_one_process():
    """Two gloo ranks share the card on (data 1, model 2) under 'tp': three
    steps of h2o-danube reduced (float32), each rank on 2 of the 4 query
    heads (the attention kernels launched 2 + 2 remat a step, as one
    process's), the losses and every parameter within 2e-4 (1 + |b|) of
    one process's step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn_local(2, _tp_pair_rank, device="cuda", timeout_s=300)
    for r in ranks:
        (l1, n1, p1), (lt, nt, pt) = r["one"], r["tp"]
        assert n1 == nt == [4, 4, 4]
        np.testing.assert_allclose(lt, l1, rtol=2e-4, atol=2e-4)
        assert sorted(pt) == sorted(p1)
        for k, v in p1.items():
            np.testing.assert_allclose(pt[k], v, rtol=2e-4, atol=2e-4, err_msg=k)


# ---------------------------------------------------------------------------
# serving under a mesh on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(300, 212), (100, 256, 156)])
def test_merge_partials_of_bf16_blocks_equals_decode_attention(blocks):
    """``decode_attention_partial`` over 2 and 3 blocks of a bf16 CUDA cache
    [4, 8, 512, 80] (GQA 32 / 8, h2o's heads), 290 slots valid so that the
    last block is all masked, merged by ``merge_partials``: the whole
    cache's ``decode_attention`` within 2e-2 (both round o to bf16 once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import attention as attn
    q, k, v = (t.to(torch.bfloat16) for t in _normal(
        41, (4, 32, 1, 80), (4, 8, 512, 80), (4, 8, 512, 80)))
    valid = torch.tensor(290, device="cuda")
    parts, start = [], 0
    for n in blocks:
        slots = torch.arange(start, start + n, device="cuda")
        parts.append(attn.decode_attention_partial(q, k[:, :, start:start + n],
                                                   v[:, :, start:start + n], slots, valid))
        start += n
    assert float(parts[-1][2].max()) == 0.0
    got = attn.merge_partials(parts).to(torch.bfloat16)
    want = attn.decode_attention(q, k, v, valid)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


def _one_by_one_serve_rank():
    from repro_torch import configs as TC
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import get_module
    from repro_torch.models.params import init_params
    from repro_torch.runtime import sharding
    from torch.utils import _pytree as pytree
    cfg = TC.reduced(TC.get_config("h2o-danube-1.8b"))
    mod = get_module(cfg)
    params = mod.load_params(cfg, init_params(1, mod.param_defs(cfg)))
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 48)).astype(np.int32)).cuda()
    struct = lm_serve.prefill_cache_struct(cfg, {"tokens": tokens})
    gather = lambda t: sharding.gather_full(t, sharding.P("data"), mesh)   # noqa: E731
    runs = {}
    for form in ("eager", "captured"):
        for m in (None, mesh):
            steps = lm_serve.captured_steps if form == "captured" else lm_serve.eager_steps
            prefill, decode = steps(cfg, params, m, "2d", None if m is None else struct)
            last, cache, _ = lm_serve.run_prefill(prefill, tokens)
            toks, logits, cache, _ = lm_serve.run_decode(
                decode, cache, 4, 6, tokens.device, None if m is None else gather)
            runs[(form, m is None)] = [last, toks, *logits, *pytree.tree_leaves(cache)]
    return mesh.backend, {form: all(torch.equal(a, b) for a, b in zip(
        runs[(form, True)], runs[(form, False)], strict=True))
        for form in ("eager", "captured")}


@pytest.mark.cuda
def test_one_by_one_nccl_serving_changes_no_bit():
    """A world of one rank under NCCL: the (1, 1) mesh's sharded prefill
    (4 x 48, one flash_attention a layer) and 6 greedy decode steps of
    h2o-danube reduced give the no-mesh steps' last hidden, tokens, logits
    and cache bit for bit, eager and captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.launch import mesh as mesh_lib
    assert mesh_lib.spawn_local(1, _one_by_one_serve_rank, device="cuda",
                                timeout_s=240) == [("nccl", {"eager": True,
                                                             "captured": True})]


# ---------------------------------------------------------------------------
# AdamW in one pass (kernels/adamw.py) and the captured train step
# ---------------------------------------------------------------------------

# n, the element offset of each of p, g, m, v in its buffer (equal offsets:
# a scalar head before the float4 body; unequal: every element scalar)
_ADAMW_CASES = {
    "odd": (1_000_003, (0, 0, 0, 0)),
    "misaligned": (100_001, (1, 1, 1, 1)),
    "offsets_differ": (4_099, (1, 2, 3, 0)),
    "three": (3, (2, 2, 2, 2)),
}


def _adamw_leaf(case, seed):
    n, offs = _ADAMW_CASES[case]
    r = np.random.default_rng(seed)
    out = []
    for i, off in enumerate(offs):
        base = r.standard_normal(n + off).astype(np.float32)
        if i == 3:
            base = np.abs(base)                 # v >= 0
        out.append(_t(base).cuda()[off:])
    return out


def _adamw_scalars(step, device="cuda"):
    c = torch.tensor(float(step), device=device)
    lr = torch.tensor(3e-4, device=device) * (0.5 + 0.1 * step)
    return lr, 1.0 - torch.pow(0.9, c), 1.0 - torch.pow(0.95, c)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("case", list(_ADAMW_CASES))
def test_adamw_kernel_equals_plain_bit_for_bit(case, scaled):
    """Three steps of the kernel against ``ref.adamw_ref`` on the card at
    an odd length, a leaf not 16-byte aligned, leaves of different
    offsets and three elements: p, m and v the same bits; g unwritten."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.kernels import adamw as kadamw
    p, g, m, v = _adamw_leaf(case, 60)
    want = [t.clone() for t in (p, m, v)]
    g0 = g.clone()
    base = kadamw.launches
    for step in range(1, 4):
        lr, bc1, bc2 = _adamw_scalars(step)
        scale = torch.tensor(0.37, device="cuda") if scaled else None
        tops.adamw_update(p, g, m, v, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
        tref.adamw_ref(want[0], g, want[1], want[2], lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    torch.cuda.synchronize()
    assert kadamw.launches == base + 3
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    assert torch.equal(g, g0)


@pytest.mark.cuda
def test_adamw_kernel_reads_its_scalars_from_device_memory_in_a_graph():
    """One update captured with 0-d rate and bias-correction tensors, then
    replayed after each was refilled: the replays follow the new values as
    the eager calls do (a rate passed by value would be baked in)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    p, g, m, v = _adamw_leaf("odd", 61)
    eager = [t.clone() for t in (p, m, v)]
    lr, bc1, bc2 = _adamw_scalars(1)
    scale = torch.tensor(0.5, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # the module loaded before capture
        tops.adamw_update(*[t.clone() for t in (p, g, m, v)], lr=lr, bc1=bc1, bc2=bc2,
                          scale=scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tops.adamw_update(p, g, m, v, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    outs = []
    for step, rate in ((1, 3e-4), (2, 5e-2)):
        new_lr, new_bc1, new_bc2 = _adamw_scalars(step)
        new_lr.fill_(rate)
        for dst, src in ((lr, new_lr), (bc1, new_bc1), (bc2, new_bc2)):
            dst.copy_(src)
        graph.replay()
        tops.adamw_update(eager[0], g, eager[1], eager[2], lr=new_lr, bc1=new_bc1,
                          bc2=new_bc2, scale=scale)
        torch.cuda.synchronize()
        outs.append(p.clone())
        for got, want in zip((p, m, v), eager):
            assert torch.equal(got, want)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_adamw_kernel_refuses_what_it_cannot_take():
    """A bfloat16 leaf, a leaf that is not contiguous, a rate that is not
    float32, a scalar on the host and, under grad mode, a leaf that
    requires grad (it is written in place) raise, nothing launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.kernels import adamw as kadamw
    p, g, m, v = (torch.ones(1000, 1000, device="cuda") for _ in range(4))
    lr, bc1, bc2 = _adamw_scalars(1)
    base = kadamw.launches
    with pytest.raises(TypeError, match="bfloat16"):
        tops.adamw_update(p.bfloat16(), g.bfloat16(), m.bfloat16(), v.bfloat16(),
                          lr=lr, bc1=bc1, bc2=bc2)
    with pytest.raises(ValueError, match="not contiguous"):
        tops.adamw_update(p, g.t(), m, v, lr=lr, bc1=bc1, bc2=bc2)
    with pytest.raises(TypeError, match="float64"):
        tops.adamw_update(p, g, m, v, lr=lr.double(), bc1=bc1, bc2=bc2)
    with pytest.raises(ValueError, match="on cpu"):
        tops.adamw_update(p, g, m, v, lr=lr.cpu(), bc1=bc1, bc2=bc2)
    with pytest.raises(RuntimeError, match="requires grad"):
        tops.adamw_update(p.requires_grad_(), g, m, v, lr=lr, bc1=bc1, bc2=bc2)
    assert kadamw.launches == base


def _train_run(arch, steps, *, captured, seed=5, resume_at=None):
    """``steps`` train steps of ``arch`` reduced (float32) on the card,
    eager or through ``captured_train_step``: each step's loss and grad
    norm, the final state's leaves, the step object and its launches.
    ``resume_at``: the state after that many steps handed to the step as
    fresh tensors (a restored checkpoint) before the next, the tensors the
    step holds overwritten first (7.0, count 99)."""
    from repro_torch import configs as TC
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.models import get_module
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.optim import AdamWState, adamw_init, warmup_cosine
    from repro_torch.runtime import build_train_step, captured_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TC.reduced(TC.get_config(arch))
    tree = init_params(seed, get_module(cfg).param_defs(cfg))
    ds = make_dataset(cfg, TC.ShapeConfig("train_4k", "train", 32, 4), seed=seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
               for s in range(steps)]
    step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10))
    if captured:
        step = captured_train_step(step)
    params = tree_map(lambda a, path: torch.from_numpy(a.copy()).cuda().requires_grad_(),
                      tree)
    opt = adamw_init(params)
    count = opt.count
    metrics, base = [], kadamw.launches
    for s, b in enumerate(batches):
        if s == resume_at:
            fresh = tree_map(lambda t, path: t.detach().clone().requires_grad_(), params)
            fresh_opt = AdamWState(opt.count.clone(), tree_map(lambda t, path: t.clone(), opt.m),
                                   tree_map(lambda t, path: t.clone(), opt.v))
            with torch.no_grad():
                for t in tree_leaves((params, opt.m, opt.v)):
                    t.fill_(7.0)
                opt.count.fill_(99)
            params, opt = fresh, fresh_opt
        params, opt, m = step(params, opt, b)
        metrics.append(torch.stack([m["loss"], m["grad_norm"], m["lr"]]))
    torch.cuda.synchronize()
    return dict(metrics=torch.stack(metrics), state=tree_leaves((params, opt.m, opt.v)),
                count=opt.count, first_count=count, step=step,
                adamw_launches=kadamw.launches - base, leaves=len(tree_leaves(params)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-1.6b", "seamless-m4t-large-v2",
                                  "recurrentgemma-2b", "qwen2-moe-a2.7b"])
def test_captured_train_step_equals_eager_bit_for_bit(arch):
    """Six steps of the reduced config (float32) captured (steps 0 and 1
    eager, step 2 captured, 3-5 replayed) against six eager steps: every
    loss, grad norm and rate and the final parameters and moments the same
    bits; the caller's own count tensor reads 6 and is the one returned;
    AdamW launched a leaf at each eager step and at the capture, never at a
    replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.runtime.capture import WARMUP
    eager = _train_run(arch, 6, captured=False)
    cap = _train_run(arch, 6, captured=True)
    assert torch.equal(cap["metrics"], eager["metrics"])
    assert all(torch.equal(a, b) for a, b in zip(cap["state"], eager["state"], strict=True))
    assert cap["count"] is cap["first_count"] and int(cap["count"]) == 6
    assert cap["step"].replays == 6 - WARMUP and cap["step"].capture_s > 0
    assert cap["adamw_launches"] == (WARMUP + 1) * cap["leaves"]
    assert eager["adamw_launches"] == 6 * eager["leaves"]


@pytest.mark.cuda
def test_captured_train_step_resumes_into_fresh_tensors_bit_for_bit():
    """The state after 4 of 6 captured steps handed back as fresh tensors
    (a checkpoint restored), the donated buffers overwritten: the fresh
    tensors are copied into them, and the last two steps and the final
    state equal a straight captured run's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    straight = _train_run("olmo-1b", 6, captured=True)
    resumed = _train_run("olmo-1b", 6, captured=True, resume_at=4)
    assert torch.equal(resumed["metrics"], straight["metrics"])
    assert all(torch.equal(a, b) for a, b in zip(resumed["state"], straight["state"]))
    assert resumed["count"] is resumed["first_count"] and int(resumed["count"]) == 6


@pytest.mark.cuda
def test_captured_train_step_refuses_host_tensors_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import captured_train_step
    cap = captured_train_step(lambda p, o, b: (p, o, {}))
    params = {"w": torch.zeros(3, device="cuda")}
    with pytest.raises(ValueError, match="on cpu"):
        cap(params, adamw_init(params), {"tokens": torch.zeros(2, dtype=torch.int32)})
