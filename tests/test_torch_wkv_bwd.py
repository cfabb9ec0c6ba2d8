"""The port's WKV backward against the JAX package's, on the CPU.

``ops.wkv_chunked`` on tensors that require grad goes through
``kernels.rwkv_chunk.WKVChunked``, whose forward is ``ref.wkv_ref`` and
whose backward is ``ref.wkv_bwd_ref`` on CPU tensors: the algorithm of
``csrc/wkv_chunked_bwd.cu``'s chunk instance in torch (states entering
each chunk, the reverse states pass, tile-factored products, each tile's
diagonal block as two exact 8-row blocks and one factored product, dlogw
by the suffix identity within each chunk, then across chunks).  The same numpy inputs go through ``jax.grad`` of
``repro.models.rwkv6.wkv_chunked`` (the jnp chunked form the reference
trains through).  Tolerances, |a - b| <= tol (1 + |b|): 2e-4, the JAX WKV
tests' own; 1e-3 at the "extreme" decays, where the float32 cumsum b
reaches a thousand or more within a chunk and b_prev - b keeps less
absolute precision in every exponent (the forward takes its exponents the
same way).  Small: B*H <= 8, T <= 130, K = V = 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import params as JP
from repro.models import rwkv6 as J
from repro_torch import configs as TC
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv_chunk as t_wkv
from repro_torch.kernels import rwkv_chunk_bwd as t_bwd
from repro_torch.models import rwkv6 as R

TOL = 2e-4
EXTREME_TOL = 1e-3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _operands(seed, B, T, H, K, decay="normal"):
    """r, k, v, u ~ N(0, 0.5^2) and logw = -exp(N(0, 0.5^2)), as the JAX WKV
    tests draw them ("strong": -exp(1.5 + N(0, 0.5^2)), steps near -4.5;
    "extreme": -exp(2.5 + N(0, 1)), steps near -12 and a chunk's decay far
    past e^88), the cotangents dout ~ N(0, 1) and dS ~ N(0, 1); [B,T,H,K]
    layout, u [H,K], dS [B,H,K,K]."""
    g = np.random.default_rng(seed)
    n = lambda *s, sc=0.5: (g.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, K)
    z = g.standard_normal((B, T, H, K)).astype(np.float32)
    logw = {"normal": -np.exp(0.5 * z), "strong": -np.exp(1.5 + 0.5 * z),
            "extreme": -np.exp(2.5 + z)}[decay].astype(np.float32)
    u = n(H, K)
    return r, k, v, logw, u, n(B, T, H, K, sc=1.0), n(B, H, K, K, sc=1.0)


def _flat(x):
    """[B,T,H,X] -> the kernel layout [B*H,T,X]."""
    B, T, H, X = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, X).contiguous()


# B, T, H, K, chunk, decay, which cotangents (out, state)
_CASES = {
    "chunk8_T64": (2, 64, 2, 16, 8, "normal", (True, False)),
    "chunk32_ragged_T75": (2, 75, 2, 16, 32, "normal", (True, False)),
    "chunk64_ragged_T130": (1, 130, 4, 16, 64, "normal", (True, False)),
    "chunk64_T_below_chunk": (2, 50, 2, 16, 64, "normal", (True, False)),
    "strong_decays": (2, 100, 2, 16, 32, "strong", (True, False)),
    "nonzero_dstate": (2, 100, 2, 16, 32, "normal", (True, True)),
    "state_only": (2, 40, 2, 16, 8, "normal", (False, True)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_wkv_chunked_gradients_match_jax_grad(case):
    """WKVChunked on CPU tensors (``wkv_ref`` forward, ``wkv_bwd_ref``
    backward) against ``jax.grad`` of the reference's jnp ``wkv_chunked``
    from a zero state: dr, dk, dv, dlogw and du (summed over the batch
    through ``u.repeat``, as the model hands u over) within 2e-4."""
    B, T, H, K, chunk, decay, (use_out, use_state) = _CASES[case]
    r, k, v, logw, u, dout, ds = _operands(sum(map(ord, case)), B, T, H, K, decay)

    def loss(r, k, v, logw, u):
        out, state = J.wkv_chunked(r, k, v, logw, u,
                                   jnp.zeros((B, H, K, K), jnp.float32), chunk)
        return (use_out * (out * dout).sum()
                + use_state * (state * ds).sum())

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (r, k, v, logw, u)]
    tr, tk, tv, tw, tu = leaves
    out, state = ops.wkv_chunked(_flat(tr), _flat(tk), _flat(tv), _flat(tw),
                                 tu.repeat(B, 1), chunk=chunk)
    assert isinstance(out.grad_fn, t_wkv.WKVChunked._backward_cls)
    total = 0.0
    if use_out:
        total = total + (out * _flat(torch.from_numpy(dout))).sum()
    if use_state:
        total = total + (state * torch.from_numpy(ds).reshape(B * H, K, K)).sum()
    total.backward()
    for name, leaf, w in zip(("dr", "dk", "dv", "dlogw", "du"), leaves, want):
        assert leaf.grad is not None, name
        _close(leaf.grad.numpy(), np.asarray(w))


def _bh_inputs(seed, BH, T, K, V, decay):
    """[BH,T,*] float64 operands and cotangents of the kernel's layout."""
    g = np.random.default_rng(seed)
    n = lambda *s, sc=0.5: torch.from_numpy(g.standard_normal(s) * sc)  # noqa: E731
    r, k, v, u = n(BH, T, K), n(BH, T, K), n(BH, T, V), n(BH, K)
    z = torch.from_numpy(g.standard_normal((BH, T, K)))
    logw = -torch.exp(0.5 * z) if decay == "normal" else -torch.exp(2.5 + z)
    return r, k, v, logw, u, n(BH, T, V, sc=1.0), n(BH, K, V, sc=1.0)


def _recurrence64(r, k, v, logw, u):
    """``wkv_ref``'s per-token recurrence, in float64."""
    BH, T, K = r.shape
    S = torch.zeros((BH, K, v.shape[-1]), dtype=torch.float64)
    outs = []
    for t in range(T):
        at = k[:, t, :, None] * v[:, t, None, :]
        outs.append((r[:, t, :, None] * (S + u[:, :, None] * at)).sum(1))
        S = torch.exp(logw[:, t])[..., None] * S + at
    return torch.stack(outs, 1), S


@pytest.mark.parametrize("decay,tol", [("normal", TOL), ("extreme", EXTREME_TOL)])
def test_wkv_bwd_ref_in_float32_matches_float64_autograd(decay, tol):
    """``ref.wkv_bwd_ref`` in float32, at chunk 64 over a ragged T = 130
    with a nonzero dS_T, against float64 autograd of the per-token
    recurrence: 2e-4 at the JAX tests' draw, 1e-3 at the extreme decays
    (see the module docstring).  The extreme draw passes e^88 within a
    chunk, so it also shows that no factor overflows."""
    r, k, v, logw, u, dout, ds = _bh_inputs(11, 4, 130, 16, 16, decay)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
    out, state = _recurrence64(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (state * ds).sum(), leaves)
    got = ref.wkv_bwd_ref(*(t.float() for t in (r, k, v, logw, u, dout)),
                          ds.float(), chunk=64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        _close(g.numpy(), w.numpy(), tol)


def test_wkv_bwd_ref_returns_the_inputs_types():
    """bfloat16 r, k, v, dout and u with float32 logw, as the bf16 train step
    hands them over: dr, dk, dv and du in bfloat16, dlogw in float32."""
    r, k, v, logw, u, dout, _ = _bh_inputs(12, 2, 20, 16, 16, "normal")
    bf = torch.bfloat16
    got = ref.wkv_bwd_ref(r.to(bf), k.to(bf), v.to(bf), logw.float(), u.to(bf),
                          dout.to(bf), chunk=8)
    assert [t.dtype for t in got] == [bf, bf, bf, torch.float32, bf]


@pytest.fixture(scope="module")
def red():
    jcfg = jreduced(jget("rwkv6-1.6b"))
    tcfg = TC.reduced(TC.get_config("rwkv6-1.6b"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JP.init_params(jax.random.PRNGKey(0), J.param_defs(jcfg)))
    return jcfg, tcfg, {k: a[0] for k, a in tree["blocks"]["tm"].items()}


def test_time_mix_gradients_match_jax(red):
    """One ``time_mix`` of the reduced config (d 64, 4 heads of 16, chunk
    8), T = 20 (ragged at chunk 8): the port's gradients of every time-mix
    weight and of x, through ``WKVChunked``, against ``jax.grad`` of the
    JAX ``time_mix`` on the same numpy weights and inputs, within 2e-4."""
    jcfg, tcfg, tm = red
    g = np.random.default_rng(13)
    x = g.standard_normal((2, 20, 64)).astype(np.float32)
    prev = g.standard_normal((2, 64)).astype(np.float32)
    cot = g.standard_normal((2, 20, 64)).astype(np.float32)
    cot_s = g.standard_normal((2, 4, 16, 16)).astype(np.float32)

    def loss(tm, x):
        out, _, state = J.time_mix(jcfg, tm, x, jnp.asarray(prev),
                                   jnp.zeros((2, 4, 16, 16), jnp.float32),
                                   jcfg.wkv_chunk)
        return (out * cot).sum() + (state * cot_s).sum()

    want_tm, want_x = jax.grad(loss, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in tm.items()}, jnp.asarray(x))
    ttm = {n: torch.from_numpy(a.copy()).requires_grad_() for n, a in tm.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out, _, state = R.time_mix(tcfg, ttm, tx, torch.from_numpy(prev), None,
                               tcfg.wkv_chunk)
    ((out * torch.from_numpy(cot)).sum()
     + (state * torch.from_numpy(cot_s)).sum()).backward()
    _close(tx.grad.numpy(), np.asarray(want_x))
    for n, leaf in ttm.items():
        assert leaf.grad is not None, n
        _close(leaf.grad.numpy(), np.asarray(want_tm[n]))


def test_ops_takes_the_autograd_function_only_where_a_gradient_is_asked():
    """No grad mode or no input requiring grad: the served call (no
    ``grad_fn``); an input that requires grad under grad mode:
    ``WKVChunked``, with the same outputs; only that input gets a
    gradient."""
    r, k, v, logw, u, _, _ = (t.float() for t in _bh_inputs(14, 2, 24, 16, 16,
                                                            "normal"))
    out, state = ops.wkv_chunked(r, k, v, logw, u, chunk=8)
    assert out.grad_fn is None and state.grad_fn is None
    tw = logw.clone().requires_grad_()
    with torch.no_grad():
        assert ops.wkv_chunked(r, k, v, tw, u, chunk=8)[0].grad_fn is None
    got, got_state = ops.wkv_chunked(r, k, v, tw, u, chunk=8)
    assert isinstance(got.grad_fn, t_wkv.WKVChunked._backward_cls)
    assert torch.equal(got.detach(), out) and torch.equal(got_state.detach(), state)
    got.sum().backward()
    assert tw.grad is not None and torch.isfinite(tw.grad).all()
    assert all(t.grad is None for t in (r, k, v, u))


def test_backward_wrapper_refuses_cpu_tensors_shapes_and_types():
    """The kernel's wrapper raises without launching: on CPU tensors
    (nothing falls back), on shapes that do not fit together, on a logw
    of another type than float32 or r's, on states of the wrong shape, and
    on a chunk whose cumsum does not fit in shared memory (with the bytes
    in the message); ``smem_bytes`` at the trained shape."""
    r, k, v, logw, u, dout, _ = (t.float() for t in _bh_inputs(15, 2, 24, 16, 16,
                                                               "normal"))
    states = torch.zeros((2, 3, 16, 16))
    before = t_bwd.launches
    with pytest.raises(ValueError, match="kernel takes CUDA tensors only"):
        t_bwd.wkv_chunked_bwd(r, k, v, logw, u, dout, states, chunk=8)
    with pytest.raises(ValueError, match="shapes"):
        t_bwd.wkv_chunked_bwd(r, k, v, logw, u, dout[:, :10], states, chunk=8)
    with pytest.raises(TypeError, match="logw is torch.float16"):
        t_bwd.wkv_chunked_bwd(r, k, v, logw.half(), u, dout, states, chunk=8)
    with pytest.raises(ValueError, match="states"):
        bf = torch.bfloat16
        t_bwd.wkv_chunked_bwd(*(t.to(bf) for t in (r, k, v)), logw, u,
                              dout.to(bf), states[:, :2], chunk=8)
    big = torch.zeros((1, 2048, 64))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        t_bwd.wkv_chunked_bwd(big, big, big, big, torch.zeros((1, 64)), big,
                              torch.zeros((1, 1, 64, 64)), chunk=2048)
    assert t_bwd.launches == before
    assert t_bwd.smem_bytes(64, 64, 64) == 103824
    assert t_bwd.smem_bytes(512, 64, 64) <= t_bwd.SMEM_LIMIT


def _source_plan():
    """The PLAN table of ``csrc/wkv_chunked_bwd.cu``: (instance, c_max,
    k_max, v_max) rows, instance 0 the chunk and 1 the tile instance."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "wkv_chunked_bwd.cu").read_text()
    body = src[src.index("constexpr PlanRow PLAN[] = {"):]
    body = body[:body.index("};")]
    return [tuple(int(x) for x in m)
            for m in re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", body)]


def test_bwd_plan_is_what_the_kernel_source_is_compiled_for():
    """``rwkv_chunk_bwd.PLAN`` equals the PLAN table the source picks its
    gradients-pass instance by; ``plan`` gives RWKV-6's trained shape
    (chunk 64, K = V = 64, bf16) the chunk instance, one block of 16 warps
    a chunk with the new layout's 186384 bytes (219152 in float32) and one
    partial row a chunk, and a chunk of 128 the tile instance with a
    partial row a tile."""
    rows = _source_plan()
    assert [(("chunk", "tiles")[i], c, kk, vv) for i, c, kk, vv in rows] == list(t_bwd.PLAN)
    got = t_bwd.plan(64, 64, 64, 2)
    assert got == dict(instance="chunk", smem=186384, parts=1)
    assert t_bwd.smem_bytes(64, 64, 64, instance="chunk", itemsize=4) == 219152
    assert t_bwd.plan(128, 64, 64, 2) == dict(
        instance="tiles", smem=t_bwd.smem_bytes(128, 64, 64), parts=8)
    assert t_bwd.plan(8, 16, 16)["instance"] == "chunk"     # one tile, one group
    assert t_bwd.plan(64, 65, 64)["instance"] == "tiles"    # wider than a warp's columns


@pytest.mark.parametrize("itemsize", [4, 2])
def test_bwd_plan_refuses_nothing_the_tile_layout_took(itemsize):
    """``check_chunk`` accepts exactly the (C, K, V) the tile layout alone
    accepted (its shared memory within the limit), and every chunk
    instance it picks fits in shared memory."""
    for C in (1, 7, 8, 16, 33, 48, 64, 65, 128, 256, 512, 1024, 2048):
        for K in (1, 8, 16, 40, 64, 65, 128, 256):
            for V in (1, 16, 40, 64, 65, 128, 512, 2560):
                took = t_bwd.smem_bytes(C, K, V) <= t_bwd.SMEM_LIMIT
                got = t_bwd.plan(C, K, V, itemsize)
                assert (got is not None) == took, (C, K, V)
                if took:
                    assert t_bwd.check_chunk(C, K, V, itemsize) == got
                    assert got["smem"] <= t_bwd.SMEM_LIMIT
                else:
                    with pytest.raises(ValueError, match="bytes of shared memory"):
                        t_bwd.check_chunk(C, K, V, itemsize)


def test_profile_wkv_bwd_instruments_the_kernel_without_a_card():
    """``python -m repro_torch.profile_wkv_bwd`` patches its stamps into a
    copy of ``csrc/wkv_chunked_bwd.cu``'s chunk instance by anchor text:
    every anchor is still there once (one stamp at the end of each phase,
    one at the start, all in ``wkv_grads_chunk_kernel``).  Nothing is
    built on the CPU."""
    from repro_torch import profile_wkv_bwd as prof
    src = prof.instrumented_source()
    assert src.count("clock64()") == len(prof.PHASES) + 1
    assert prof.PHASES == ("loads", "cumsum", "blocks", "diagonal", "states",
                           "visits", "suffix", "stores")
    kernel = src[src.index("wkv_grads_chunk_kernel("):src.index("// 3. the finishing pass")]
    assert kernel.count("clock64()") == len(prof.PHASES) + 1
    assert 'extern "C" int repro_wkv_bwd_stamps' in src


def test_ptxas_reads_each_gradients_pass_instance():
    """``rwkv_chunk_bwd.ptxas`` reads the registers and spill bytes of each
    gradients-pass instance from an ``nvcc -Xptxas -v`` log (the lines it
    prints for a kernel: its mangled name, then its frame, then its
    registers), and a parent source's single ``wkv_grads_kernel`` as a tile
    instance; other kernels are not read."""
    def entry(name, regs, st=0, ld=0):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    8 bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers\n")
    log = (entry("_ZN12_GLOBAL__N_122wkv_grads_chunk_kernelI13__nv_bfloat16EEvPKT_", 124)
           + entry("_ZN12_GLOBAL__N_122wkv_grads_chunk_kernelIfEEvPKT_", 117, 8, 12)
           + entry("_ZN12_GLOBAL__N_121wkv_grads_tile_kernelIfEEvPKT_", 127)
           + entry("_ZN12_GLOBAL__N_118wkv_rstates_kernelIfEEvPKT_", 40))
    assert t_bwd.ptxas(log) == {"chunk bfloat16": (124, 0, 0), "chunk float32": (117, 8, 12),
                                "tiles float32": (127, 0, 0)}
    parent = entry("_ZN12_GLOBAL__N_116wkv_grads_kernelI13__nv_bfloat16EEvPKT_", 121)
    assert t_bwd.ptxas(parent) == {"tiles bfloat16": (121, 0, 0)}
