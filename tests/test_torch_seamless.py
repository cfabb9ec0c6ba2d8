"""The port's Seamless encoder-decoder against the JAX package, on the CPU.

Everything runs at ``reduced(seamless-m4t-large-v2)`` size (2 encoder and
2 decoder layers, d 64, 4 heads of 16, LayerNorm with biases, tanh-GELU,
float32).  Weights come from ``repro.models.params.init_params``, are
turned to numpy and carried across by ``seamless.load_params``; source
frames and tokens are numpy arrays from a seed.  Tolerance 2e-4, as in the
JAX tests: float32 sums in another order (the port's attention is the
plain ``ref.attention_ref`` on the CPU, the JAX one its blocked online
softmax).  The whole file takes ~10 s, most of it JAX's compiles.
"""
import dataclasses
import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import params as JP
from repro.models import seamless as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import get_module
from repro_torch.models import params as TP
from repro_torch.models import seamless as S
from repro_torch.runtime import build_decode_step, build_prefill_step, donating

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-large-v2"
TOL = 2e-4
# the uncut configuration's parameters (embedding and LM head at the padded
# vocabulary of 256,256), as the JAX package counts them
FULL_PARAMS = 1_632_358_400


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


_M: dict = {}


def _model():
    if not _M:
        jcfg, tcfg = jreduced(jget(ARCH)), TC.reduced(TC.get_config(ARCH))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
            lambda key: JP.init_params(key, J.param_defs(jcfg)))(
                jax.random.PRNGKey(0)))
        _M["m"] = types.SimpleNamespace(
            jcfg=jcfg, tcfg=tcfg, tree=tree, jp=jax.tree.map(jnp.asarray, tree),
            tp=S.load_params(tcfg, tree, device="cpu"))
    return _M["m"]


def _batch(cfg, seed, B, S_src, T):
    r = np.random.default_rng(seed)
    return {"inputs_embeds": r.standard_normal((B, S_src, cfg.d_model)
                                               ).astype(np.float32),
            "tokens": r.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


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
    assert get_module(b) is S


def test_param_defs_match_jax():
    jcfg, tcfg = jget(ARCH), TC.get_config(ARCH)
    jdefs = jax.tree_util.tree_flatten_with_path(
        J.param_defs(jcfg), is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path):
            (tuple(d.shape), d.init, d.scale) for path, d in jdefs}
    got = {}
    TP.tree_map(lambda d, path: got.__setitem__(path, (tuple(d.shape), d.init,
                                                       d.scale)),
                S.param_defs(tcfg))
    assert got == want
    assert TP.count_params(S.param_defs(tcfg)) == JP.count_params(
        J.param_defs(jcfg)) == FULL_PARAMS


def test_load_params_casts_what_jax_casts_at_each_use():
    m = _model()
    p = S.load_params(dataclasses.replace(m.tcfg, dtype="bfloat16"), m.tree,
                      device="cpu")
    for path in S.COMPUTE_DTYPE_LEAVES:
        node = p
        for key in path.split("."):
            node = node.get(key) if isinstance(node, dict) else None
        assert node is None or node.dtype == torch.bfloat16, path
    assert p["dec_blocks"]["xattn"]["wq"].dtype == torch.bfloat16
    for norm in (p["enc_ln_f"], p["dec_blocks"]["ln_x"]):
        assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
    assert p["embed"]["unembed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_sinusoid_matches_jax():
    pos = np.random.default_rng(0).integers(0, 1600, (2, 40)).astype(np.int32)
    _close(S.sinusoid(_t(pos), 64), J.sinusoid(jnp.asarray(pos), 64), 1e-5)
    assert S.sinusoid(_t(pos), 64).dtype == torch.float32


def test_encode_matches_jax():
    m = _model()
    x = _batch(m.jcfg, 1, 2, 37, 1)["inputs_embeds"]
    want = jax.jit(functools.partial(J.encode, m.jcfg, remat=False))(
        m.jp, jnp.asarray(x))
    _close(S.encode(m.tcfg, m.tp, _t(x)), want)


def test_forward_matches_jax():
    m = _model()
    jb, tb = _both(_batch(m.jcfg, 2, 2, 30, 9))
    jh, _ = jax.jit(functools.partial(J.forward, m.jcfg, remat=False))(m.jp, jb)
    th, aux = S.forward(m.tcfg, m.tp, tb)
    _close(th, jh)
    _close(S.logits_fn(m.tcfg, m.tp, th), J.logits_fn(m.jcfg, m.jp, jh))
    assert float(aux) == 0.0


def test_prefill_with_decode_len_and_decode_steps_match_jax():
    """Prefill over 1 decoder token and 33 frames with the self cache padded
    to 40, then 6 decode steps fed tokens: last hidden, the four caches and
    the step after prefill, logits and caches after each step."""
    m = _model()
    jb, tb = _both(_batch(m.jcfg, 3, 2, 33, 1))
    jlast, jc = jax.jit(functools.partial(J.prefill, m.jcfg, decode_len=40))(m.jp, jb)
    tlast, tc = S.prefill(m.tcfg, m.tp, tb, decode_len=40)
    assert tuple(tc.self_k.shape) == (2, 2, 4, 40, 16) == tuple(jc.self_k.shape)
    assert tuple(tc.cross_k.shape) == (2, 2, 4, 33, 16)
    assert tc.step.dtype == torch.int32 and int(tc.step) == int(jc.step) == 1
    _close(tlast, jlast)
    for name in S.SeamlessCache._fields[:4]:
        _close(getattr(tc, name), getattr(jc, name))
    toks = np.random.default_rng(4).integers(0, m.jcfg.vocab_size, (2, 6),
                                             dtype=np.int32)
    jdec = jax.jit(functools.partial(J.decode_step, m.jcfg))
    for i in range(6):
        jl, jc = jdec(m.jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tl, tc = S.decode_step(m.tcfg, m.tp, tc, {"tokens": _t(toks[:, i:i + 1])})
        _close(tl, jl)
        _close(tc.self_k, jc.self_k)
        _close(tc.self_v, jc.self_v)
        assert int(tc.step) == int(jc.step) == i + 2


def test_decode_matches_forward():
    """Stepwise decode logits == teacher-forced forward logits against the
    same encoder memory (port of the reference's
    ``test_decode_matches_forward_seamless``)."""
    m = _model()
    b = _batch(m.jcfg, 5, 1, 10, 8)
    tb = {k: _t(v) for k, v in b.items()}
    hidden, _ = S.forward(m.tcfg, m.tp, tb, kernels=tref.PLAIN)
    full = S.logits_fn(m.tcfg, m.tp, hidden)
    _, cache = S.prefill(m.tcfg, m.tp, {"inputs_embeds": tb["inputs_embeds"],
                                        "tokens": tb["tokens"][:, :1]},
                         decode_len=8)
    for t in range(1, 8):
        logits, cache = S.decode_step(m.tcfg, m.tp, cache,
                                      {"tokens": tb["tokens"][:, t:t + 1]})
        _close(logits[0], full[0, t], 3e-3)


def test_prompts_go_through_the_kernel_three_times_a_layer_and_decode_never():
    """Encoder self-attention (non-causal), decoder self-attention (causal)
    and cross-attention (non-causal, Sq = the prefix, Sk = the frames)."""
    m = _model()
    calls = []

    def fa(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return tref.attention_ref(q, k, v, **kw)

    kern = types.SimpleNamespace(flash_attention=fa)
    tb = {k: _t(v) for k, v in _batch(m.jcfg, 6, 1, 15, 1).items()}
    _, cache = build_prefill_step(m.tcfg, decode_len=20, kernels=kern)(m.tp, tb)
    assert len(calls) == S.kernel_launches_per_prefill(m.tcfg)["flash_attention"] == 6
    assert calls == [(15, 15, False)] * 2 + [(1, 1, True), (1, 15, False)] * 2
    assert cache.self_k.shape[3] == 20
    build_decode_step(m.tcfg, kernels=kern)(m.tp, cache, {"tokens": tb["tokens"]})
    assert len(calls) == 6
    assert S.kernel_launches_per_prefill(TC.get_config(ARCH)) == {"flash_attention": 72}


def test_donated_decode_chain_equals_the_functional_one_and_copies_no_cross_kv():
    """``donating(decode, 1)`` gives the functional steps' tokens, logits and
    caches bit for bit; the step hands the cross K/V on as the same tensors,
    so the donated copy of them is a copy of a buffer onto itself (which
    ATen skips) and they are never written after prefill."""
    m = _model()
    tb = {k: _t(v) for k, v in _batch(m.jcfg, 7, 2, 21, 1).items()}
    prefill, decode = build_prefill_step(m.tcfg, decode_len=27), build_decode_step(m.tcfg)
    donated = donating(decode, 1)
    _, c1 = prefill(m.tp, tb)
    _, c2 = prefill(m.tp, tb)
    xk, xv = c2.cross_k, c2.cross_v
    xk0 = xk.clone()
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(5):
        t1, l1, c1n = decode(m.tp, c1, {"tokens": tok})
        assert c1n.cross_k is c1.cross_k and c1n.cross_v is c1.cross_v
        c1 = c1n
        t2, l2, c2b = donated(m.tp, c2, {"tokens": tok})
        assert c2b is c2 and c2.cross_k is xk and c2.cross_v is xv
        for a, b in zip((t1, l1, *c1), (t2, l2, *c2)):
            assert torch.equal(a, b)
        tok = t1[:, None]
    assert torch.equal(xk, xk0)


def test_jax_steps_and_serve_on_cpu_give_the_same_greedy_tokens(capsys):
    """The launcher (frames drawn after the tokens, the tokens' first column
    as the decoder prefix, the self cache sized prompt + gen) against JAX's
    ``build_prefill_step(decode_len=)`` / ``build_decode_step`` on the
    port's seeded weights and inputs."""
    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "14", "--gen", "6",
                       "--seed", "5"])
    assert "prefill[2x14]" in capsys.readouterr().out
    jcfg = jreduced(jget(ARCH))
    jp = jax.tree.map(jnp.asarray, TP.init_params(
        5, S.param_defs(TC.reduced(TC.get_config(ARCH)))))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 14), dtype=np.int32)
    embeds = rng.standard_normal((2, 14, jcfg.d_model)).astype(np.float32)
    _, cache = jax.jit(j_prefill_step(jcfg, decode_len=20))(
        jp, {"tokens": jnp.asarray(toks[:, :1]), "inputs_embeds": jnp.asarray(embeds)})
    assert cache.self_k.shape[3] == 20
    decode = jax.jit(j_decode_step(jcfg))
    tok, want = jnp.zeros((2, 1), jnp.int32), []
    for _ in range(6):
        tok1, _, cache = decode(jp, cache, {"tokens": tok})
        tok = tok1[:, None]
        want.append(np.asarray(tok1))
    np.testing.assert_array_equal(out["tokens"], np.stack(want, 1))


def test_seamless_and_moe_load_no_jax_and_build_nothing():
    code = ("import sys; import repro_torch.models.seamless, "
            "repro_torch.models.layers, repro_torch.configs.qwen2_moe_a2_7b, "
            "repro_torch.configs.seamless_m4t_large_v2; "
            "from repro_torch.kernels import _build; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'jax or repro imported'; "
            "assert _build.build_seconds is None")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)
