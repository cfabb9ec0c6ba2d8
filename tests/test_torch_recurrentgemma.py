"""The port's RecurrentGemma hybrid against the JAX package, on the CPU.

Everything runs at ``reduced(...)`` size: 3 layers (recurrent, recurrent,
attention), d 64, 4 query heads of 16 over 1 KV head, LRU width 64,
window 32, float32.  Weights come from ``repro.models.params.init_params``,
are turned to numpy and carried across by ``recurrentgemma.load_params``;
tokens and activations are numpy arrays from a seed.  Tolerance 2e-4,
the attention and scan tolerance of the JAX tests: float32 sums taken in
another order (the port's scan doubles where ``lax.associative_scan``
goes odd / even; its prefill attention is the plain ``ref.attention_ref``
on the CPU).  The JAX outputs are computed once, in module-scope
fixtures: its compiles are most of the file's ~20 s.
"""
import dataclasses
import functools
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import params as JP
from repro.models import recurrentgemma as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.kernels import ref as tref
from repro_torch.models import get_module
from repro_torch.models import params as TP
from repro_torch.models import recurrentgemma as R
from repro_torch.runtime import build_decode_step, build_prefill_step, donating

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
ARCH = "recurrentgemma-2b"
# the uncut model's parameters (the JAX package's count: embedding and LM
# head at the padded vocabulary)
FULL_PARAMS = 3_549_934_080
# the served shape past the reduced window (32): a banded prefill, a ring
B, S, STEPS = 2, 40, 6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def m():
    """(JAX config, port config, numpy tree, JAX params, port params) at
    reduced size; the recurrent block of layer 0 on both sides."""
    jcfg, tcfg = jreduced(jget(ARCH)), TC.reduced(TC.get_config(ARCH))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        lambda key: JP.init_params(key, J.param_defs(jcfg)))(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = R.load_params(tcfg, tree, device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, tree=tree, jp=jp, tp=tp,
                                 jrec=jp["blocks"][0]["rec"],
                                 trec=tp["blocks"][0]["rec"])


@pytest.fixture(scope="module")
def served(m):
    """JAX's jitted steps on a 2 x 40 prompt: the prefill (last hidden,
    cache), then STEPS greedy decode steps from token 0 (tokens, logits,
    the cache after each), and the forward's hidden states."""
    toks = np.random.default_rng(2).integers(0, m.jcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    last, cache = jax.jit(j_prefill_step(m.jcfg))(m.jp, jb)
    out = types.SimpleNamespace(toks=toks, last=last, cache=cache, steps=[])
    dec = jax.jit(j_decode_step(m.jcfg))
    tok = jnp.zeros((B, 1), jnp.int32)
    for _ in range(STEPS):
        t1, lg, cache = dec(m.jp, cache, {"tokens": tok})
        out.steps.append((np.asarray(t1), np.asarray(lg), cache))
        tok = t1[:, None]
    out.hidden = jax.jit(functools.partial(J.forward, m.jcfg, remat=False))(
        m.jp, jb)[0]
    return out


# ---------------------------------------------------------------------------
# configuration, registry, parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_is_a_faithful_copy(which):
    a, b = jget(ARCH), TC.get_config(ARCH)
    if which == "reduced":
        a, b = jreduced(a), TC.reduced(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.compute_dtype == getattr(torch, a.dtype)
    assert get_module(b) is R
    assert b.block_pattern.count("attention") == (8 if which == "CONFIG" else 1)


def _flat(defs, jax_side):
    if jax_side:
        flat = jax.tree_util.tree_flatten_with_path(
            defs, is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]
        norm = lambda k: re.sub(r"\['?([^'\]]+)'?\]", r".\1", k).lstrip(".")  # noqa: E731
        return {norm(jax.tree_util.keystr(k)): (tuple(d.shape), d.init, d.scale)
                for k, d in flat}
    out = {}
    TP.tree_map(lambda d, path: out.__setitem__(
        path, (tuple(d.shape), d.init, d.scale)), defs)
    return out


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_param_defs_match_jax(which):
    jcfg, tcfg = jget(ARCH), TC.get_config(ARCH)
    if which == "reduced":
        jcfg, tcfg = jreduced(jcfg), TC.reduced(tcfg)
    a, b = J.param_defs(jcfg), R.param_defs(tcfg)
    assert _flat(a, True) == _flat(b, False)
    assert TP.count_params(b) == JP.count_params(a)
    if which == "CONFIG":
        assert TP.count_params(b) == FULL_PARAMS


def test_load_params_casts_what_jax_casts_at_each_use(m):
    cfg = dataclasses.replace(m.tcfg, dtype="bfloat16")
    p = R.load_params(cfg, m.tree, device="cpu")
    cast = set(R.compute_dtype_leaves(cfg))
    seen = []

    def check(t, path):
        seen.append(path)
        assert t.dtype == (torch.bfloat16 if path in cast else torch.float32), path

    TP.tree_map(check, p)
    assert cast <= set(seen)
    rec = p["blocks"][0]["rec"]
    assert rec["gate_i"].dtype == rec["lam"].dtype == torch.float32
    assert p["embed"]["unembed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the RG-LRU and the temporal convolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_jax(m, with_h0):
    """At a ragged T (50: neither a power of 2 nor a multiple of one)."""
    u = _n(1, 2, 50, m.tcfg.lru_width)
    h0 = _n(2, 2, m.tcfg.lru_width) if with_h0 else None
    jy, jh = J.rg_lru(m.jrec, jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    ty, th = R.rg_lru(m.trec, _t(u), None if h0 is None else _t(h0))
    _close(ty, jy)
    _close(th, jh)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32


def test_rg_lru_keeps_the_input_dtype_and_a_float32_state(m):
    u = _t(_n(3, 1, 9, m.tcfg.lru_width)).to(torch.bfloat16)
    y, h = R.rg_lru(m.trec, u)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, R.rg_lru(m.trec, u.float())[0].to(torch.bfloat16))


def test_rg_lru_step_matches_jax(m):
    u, h = _n(4, 3, m.tcfg.lru_width), _n(5, 3, m.tcfg.lru_width)
    jy, jh = J.rg_lru_step(m.jrec, jnp.asarray(u), jnp.asarray(h))
    ty, th = R.rg_lru_step(m.trec, _t(u), _t(h))
    _close(ty, jy)
    _close(th, jh)


def test_linear_scan_is_the_recurrence_at_every_length():
    """T = 1 .. 33 (every round count up to 6, ragged and not), decays down
    to products that underflow to 0."""
    for T in range(1, 34):
        a = torch.from_numpy(np.random.default_rng(T).uniform(0.0, 1.0, (2, T, 3))
                             .astype(np.float32)) ** 40
        b = _t(_n(T, 2, T, 3))
        h, want = torch.zeros(2, 3), []
        for t in range(T):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(R.linear_scan(a, b), torch.stack(want, 1),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(m, with_state):
    x = _n(6, 2, 13, m.tcfg.lru_width)
    st = _n(7, 2, m.tcfg.conv1d_width - 1, m.tcfg.lru_width) if with_state else None
    jy, jst = J.causal_conv1d(m.jrec, jnp.asarray(x),
                              None if st is None else jnp.asarray(st))
    ty, tst = R.causal_conv1d(m.trec, _t(x), None if st is None else _t(st))
    _close(ty, jy, 1e-5)
    _close(tst, jst, 0)


def test_rg_lru_scan_equals_stepwise(m):
    """Port of the reference's ``test_rg_lru_scan_equals_stepwise``."""
    u = _t(_n(9, 2, 16, m.tcfg.lru_width))
    y, h_last = R.rg_lru(m.trec, u)
    h = torch.zeros(2, m.tcfg.lru_width)
    for t in range(16):
        yt, h = R.rg_lru_step(m.trec, u[:, t], h)
        _close(y[:, t], yt)
    _close(h_last, h)


def test_causal_conv1d_state_continuity(m):
    """conv(x) == conv(x[:8]) ++ conv(x[8:], carried state): port of the
    reference's ``test_causal_conv1d_state_continuity``."""
    x = _t(_n(4, 2, 16, m.tcfg.lru_width))
    y_full, _ = R.causal_conv1d(m.trec, x)
    y1, st = R.causal_conv1d(m.trec, x[:, :8])
    y2, _ = R.causal_conv1d(m.trec, x[:, 8:], st)
    _close(y_full, torch.cat([y1, y2], 1), 1e-5)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_forward_matches_jax(m, served):
    th, aux = R.forward(m.tcfg, m.tp, {"tokens": _t(served.toks)})
    _close(th, served.hidden)
    assert float(aux) == 0.0
    _close(R.logits_fn(m.tcfg, m.tp, th),
           J.logits_fn(m.jcfg, m.jp, served.hidden))


def _close_cache(tc, jc):
    for name in ("rec_h", "conv_state", "attn_k", "attn_v"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape, name
            _close(g, w)
    assert int(tc.step) == int(jc.step) and tc.step.dtype == torch.int32


def test_prefill_and_decode_steps_match_jax(m, served):
    """The port's step builders against JAX's under ``jax.jit`` at 40
    tokens, past the window of 32: the banded prefill and a ring of 32 K/V
    slots; then 6 greedy steps from token 0, tokens equal, logits and every
    cache leaf within tolerance."""
    tlast, tc = build_prefill_step(m.tcfg)(m.tp, {"tokens": _t(served.toks)})
    _close(tlast, served.last)
    _close_cache(tc, served.cache)
    assert tuple(tc.attn_k[0].shape) == (B, 1, m.tcfg.window, m.tcfg.head_dim)
    dec = build_decode_step(m.tcfg)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    V = m.tcfg.vocab_size
    for j1, jl, jc in served.steps:
        t1, tl, tc = dec(m.tp, tc, {"tokens": tok})
        np.testing.assert_array_equal(t1.numpy(), j1)
        _close(tl[:, :V], jl[:, :V])
        _close_cache(tc, jc)
        tok = t1[:, None]


def test_decode_matches_forward_recurrentgemma(m):
    """Scan prefill == stepwise decode across the state handoff, on a cache
    grown to the whole sequence first (port of the reference's
    ``test_decode_matches_forward_recurrentgemma``)."""
    Tn, prefix = 12, 6
    toks = _t(np.random.default_rng(5).integers(0, m.tcfg.vocab_size, (1, Tn),
                                                dtype=np.int32))
    hidden, _ = R.forward(m.tcfg, m.tp, {"tokens": toks}, kernels=tref.PLAIN)
    full = R.logits_fn(m.tcfg, m.tp, hidden)
    _, cache = R.prefill(m.tcfg, m.tp, {"tokens": toks[:, :prefix]})
    grow = lambda c: torch.nn.functional.pad(c, (0, 0, 0, Tn - c.shape[2]))  # noqa: E731
    cache = cache._replace(attn_k=[grow(k) for k in cache.attn_k],
                           attn_v=[grow(v) for v in cache.attn_v])
    for t in range(prefix, Tn):
        logits, cache = R.decode_step(m.tcfg, m.tp, cache,
                                      {"tokens": toks[:, t:t + 1]})
        _close(logits[0], full[0, t], 3e-3)


def test_init_cache_has_the_prefill_cache_structure(m):
    _, pc = R.prefill(m.tcfg, m.tp, {"tokens": torch.zeros((2, 40), dtype=torch.int32)})
    ic = R.init_cache(m.tcfg, 2, 40, device="cpu")
    for a, b in zip(pytree.tree_leaves(pc), pytree.tree_leaves(ic), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert pytree.tree_structure(pc) == pytree.tree_structure(ic)


def test_donated_decode_chain_equals_the_functional_one(m):
    """``donating(decode, 1)`` keeps the heterogeneous cache (per-layer
    lists of three shapes) in one set of buffers, bit for bit the
    functional steps."""
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, m.tcfg.vocab_size, (2, 40), dtype=np.int32))
    _, cache = build_prefill_step(m.tcfg)(m.tp, {"tokens": toks})
    buf = pytree.tree_map(torch.clone, cache)
    leaves = pytree.tree_leaves(buf)
    dec = build_decode_step(m.tcfg)
    don = donating(dec, 1)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(4):
        t1, l1, cache = dec(m.tp, cache, {"tokens": tok})
        t2, l2, out = don(m.tp, buf, {"tokens": tok})
        assert out is buf and torch.equal(t1, t2) and torch.equal(l1, l2)
        for a, b, keep in zip(pytree.tree_leaves(cache),
                              pytree.tree_leaves(out), leaves):
            assert torch.equal(a, b) and b is keep
        tok = t1[:, None]


def test_prompts_go_through_the_kernel_once_an_attention_block_and_decode_never(m):
    """Counted through a recording ``kernels`` namespace: one launch for
    the one attention block of the reduced pattern, banded past the window;
    the full pattern's count is 8."""
    calls = []

    def fa(q, k, v, **kw):
        calls.append((q.shape[2], kw["causal"], kw["window"]))
        return tref.attention_ref(q, k, v, **kw)

    kern = types.SimpleNamespace(flash_attention=fa)
    tb = {"tokens": torch.zeros((1, 40), dtype=torch.int32)}
    _, cache = build_prefill_step(m.tcfg, kernels=kern)(m.tp, tb)
    assert len(calls) == R.kernel_launches_per_prefill(m.tcfg)["flash_attention"] == 1
    assert calls == [(40, True, m.tcfg.window)]
    build_decode_step(m.tcfg, kernels=kern)(m.tp, cache, {"tokens": tb["tokens"][:, :1]})
    R.forward(m.tcfg, m.tp, tb, kernels=kern)
    assert len(calls) == 2
    assert R.kernel_launches_per_prefill(TC.get_config(ARCH)) == {"flash_attention": 8}


def test_recurrentgemma_loads_no_jax_and_builds_nothing():
    code = ("import sys; import repro_torch.models.recurrentgemma, "
            "repro_torch.configs.recurrentgemma_2b; "
            "from repro_torch.kernels import _build; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'jax or repro imported'; "
            "assert _build.build_seconds is None")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)
