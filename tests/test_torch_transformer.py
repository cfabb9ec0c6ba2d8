"""The port's dense and VLM transformer against the JAX package, on the CPU.

Everything runs at ``reduced(...)`` size (2 layers, d 64, 4 heads of 16,
float32; the window of ``h2o-danube-1.8b`` becomes 32) for the five ported
configurations.  Weights come from ``repro.models.params.init_params``,
are turned to numpy and carried across by ``transformer.load_params``;
tokens, embeddings and attention operands are numpy arrays from a seed.
Tolerance 2e-4, the attention tolerance of the JAX tests: float32 sums
taken in another order (the port's prefill attention is the plain
``ref.attention_ref`` on the CPU, the JAX one its blocked online softmax)
through two layers.  The whole file takes ~30 s, most of it JAX's compiles.
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

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as A
from repro_torch.models import get_module
from repro_torch.models import layers as L
from repro_torch.models import params as TP
from repro_torch.models import transformer as T
from repro_torch.runtime import build_decode_step, build_prefill_step, donating

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
ARCHS = ["h2o-danube-1.8b", "olmo-1b", "minitron-4b", "starcoder2-15b",
         "qwen2-vl-2b"]
# published parameter counts of the uncut configurations (embedding and
# LM head at the padded vocabulary), as the JAX package counts them
FULL_PARAMS = {"h2o-danube-1.8b": 1_831_201_280, "olmo-1b": 1_176_764_416,
               "minitron-4b": 4_190_509_056, "starcoder2-15b": 15_956_127_744,
               "qwen2-vl-2b": 1_777_030_656}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


_MODELS: dict = {}


def _model(arch):
    """(JAX config, port config, numpy tree, JAX params, port params) at
    reduced size, built once per arch."""
    if arch not in _MODELS:
        jcfg = jreduced(jget(arch))
        tcfg = TC.reduced(TC.get_config(arch))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
            lambda key: JP.init_params(key, J.param_defs(jcfg)))(
                jax.random.PRNGKey(0)))
        _MODELS[arch] = types.SimpleNamespace(
            jcfg=jcfg, tcfg=tcfg, tree=tree, jp=jax.tree.map(jnp.asarray, tree),
            tp=T.load_params(tcfg, tree, device="cpu"),
            jprefill=jax.jit(functools.partial(J.prefill, jcfg)),
            jdecode=jax.jit(functools.partial(J.decode_step, jcfg)))
    return _MODELS[arch]


def _batch(cfg, seed, B, S):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.embedding_inputs:
        batch["inputs_embeds"] = r.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# configurations, registry, parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_faithful_copy(arch, which):
    a, b = jget(arch), TC.get_config(arch)
    if which == "reduced":
        a, b = jreduced(a), TC.reduced(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.compute_dtype == getattr(torch, a.dtype)
    assert get_module(b) is T


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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_jax(arch):
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    a, b = J.param_defs(jcfg), T.param_defs(tcfg)
    assert _flat(a, True) == _flat(b, False)
    assert TP.count_params(b) == JP.count_params(a)
    if arch in FULL_PARAMS:
        assert TP.count_params(b) == FULL_PARAMS[arch]


def test_moe_and_audio_raise_naming_their_roadmap_item():
    """The MoE and audio families were refused until ROADMAP queue 1 item 6b
    ported them, and the hybrid family until item 5 did: now their configs
    resolve and their modules serve them (``tests/test_torch_moe.py``,
    ``tests/test_torch_seamless.py``, ``tests/test_torch_recurrentgemma.py``),
    and no LM family or architecture of the JAX package is refused."""
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2",
                 "recurrentgemma-2b"):
        assert get_module(TC.get_config(arch)).__name__.rsplit(".", 1)[1] == (
            "seamless" if arch.startswith("seamless") else
            "recurrentgemma" if arch.startswith("recurrentgemma") else "transformer")
    moe = dataclasses.replace(TC.get_config("olmo-1b"), moe=TC.MoEConfig(
        num_experts=4, num_experts_padded=4, top_k=2, d_ff_expert=32))
    assert "moe" in T.param_defs(moe)["blocks"]
    assert get_module(dataclasses.replace(moe, family="moe")) is T
    assert get_module(dataclasses.replace(moe, family="hybrid")).__name__ == \
        "repro_torch.models.recurrentgemma"
    assert not TC.NOT_PORTED
    with pytest.raises(ValueError, match="unknown family"):
        get_module(dataclasses.replace(moe, family="diffusion"))


def test_load_params_casts_what_jax_casts_at_each_use():
    m = _model("h2o-danube-1.8b")
    cfg = dataclasses.replace(m.tcfg, dtype="bfloat16")
    p = T.load_params(cfg, m.tree, device="cpu")
    # a dense model holds no MoE leaves (tests/test_torch_moe.py checks those)
    for path in [p for p in T.COMPUTE_DTYPE_LEAVES if not p.startswith("blocks.moe")]:
        head, leaf = path.rsplit(".", 1)
        node = p
        for k in head.split("."):
            node = node[k]
        assert node[leaf].dtype == torch.bfloat16, path
    assert p["embed"]["unembed"].dtype == torch.float32
    assert p["blocks"]["ln1"]["scale"].dtype == torch.float32
    tied = T.load_params(dataclasses.replace(_model("olmo-1b").tcfg,
                                             dtype="bfloat16"),
                         _model("olmo-1b").tree, device="cpu")
    assert tied["embed"]["embedding"].dtype == torch.float32


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = _model("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA"):
        T.load_params(m.tcfg, m.tree)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--arch", "h2o-danube-1.8b", "--reduced"])


# ---------------------------------------------------------------------------
# the attention library (ports of tests/test_attention_lib.py's forward tests)
# ---------------------------------------------------------------------------


def _qkv(sq=64, sk=64, h=2, d=16, b=2, seed=1):
    return (_n(seed, b, h, sq, d), _n(seed + 1, b, h, sk, d),
            _n(seed + 2, b, h, sk, d))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (True, 64)])
def test_flash_attention_matches_jax(causal, window):
    q, k, v = _qkv()
    want = jax.jit(lambda q, k, v: JA.flash_attention(
        q, k, v, causal, window, None, 16, 16))(*map(jnp.asarray, (q, k, v)))
    got = A.flash_attention(*map(_t, (q, k, v)), causal, window)
    _close(got, want)
    _close(A.reference_attention(*map(_t, (q, k, v)), causal, window),
           JA.reference_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  window=window))


@pytest.mark.parametrize("window", [16, 32])
def test_banded_prefill_matches_jax(window):
    q, k, v = _qkv(sq=128, sk=128)
    want = JA.flash_attention_banded(*map(jnp.asarray, (q, k, v)), window,
                                     block_q=32, block_k=32)
    _close(A.flash_attention_banded(*map(_t, (q, k, v)), window), want)


def test_prefill_attention_routes_to_the_kernel_entry_point():
    """Both prefill entry points call ``kernels.flash_attention`` once, the
    banded one causal with the window, with dense operands and no block
    keywords."""
    calls = []

    def fa(q, k, v, **kw):
        calls.append((kw, q.is_contiguous() and k.is_contiguous()
                      and v.is_contiguous()))
        return tref.attention_ref(q, k, v, **kw)

    q, k, v = map(_t, _qkv(sq=20, sk=20))
    spy = types.SimpleNamespace(flash_attention=fa)
    A.flash_attention(q, k.transpose(2, 3).transpose(2, 3), v, False, 7,
                      kernels=spy)
    A.flash_attention_banded(q, k, v, 5, kernels=spy)
    assert calls == [(dict(causal=False, window=7, scale=None), True),
                     (dict(causal=True, window=5, scale=None), True)]


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("gqa", [1, 4])
def test_decode_attention_matches_jax(gqa, ring):
    b, hkv, S, d = 2, 2, 32, 16
    q1 = _n(3, b, hkv * gqa, 1, d)
    kc, vc = _n(4, b, hkv, S, d), _n(5, b, hkv, S, d)
    valid = S if ring else 20
    want = JA.decode_attention(jnp.asarray(q1), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.array(valid), ring=ring)
    got = A.decode_attention(_t(q1), _t(kc), _t(vc),
                             torch.tensor(valid, dtype=torch.int32), ring=ring)
    _close(got, want)
    # and the last row of full attention over the valid positions
    kr = np.repeat(kc[:, :, :valid], gqa, axis=1)
    vr = np.repeat(vc[:, :, :valid], gqa, axis=1)
    _close(got, tref.attention_ref(_t(q1), _t(kr), _t(vr), causal=False))


def test_softmax_normalization_property():
    q, k, _ = map(_t, _qkv(sq=48, sk=48))
    v = torch.full((2, 2, 48, 16), 3.5)
    for window in (None, 8):
        _close(A.flash_attention(q, k, v, True, window), np.full((2, 2, 48, 16), 3.5),
               1e-5)


# ---------------------------------------------------------------------------
# layers (ports of tests/test_models_internal.py's RoPE / M-RoPE / ibn tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    x = _n(6, 2, 4, 16, 32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16)) * 7
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos.copy()), theta)
    _close(got, want, 1e-5 * theta ** 0.5)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), np.linalg.norm(x, axis=-1),
                               rtol=1e-4, atol=1e-4)


def test_apply_mrope_matches_jax_and_equals_rope_on_equal_streams():
    cfg = jget("qwen2-vl-2b")
    x = _n(7, 2, 4, 8, cfg.head_dim)
    pos3 = np.random.default_rng(8).integers(0, 50, (3, 2, 8)).astype(np.int32)
    want = jax.jit(lambda a, p: JL.apply_mrope(a, p, cfg.rope_theta,
                                               cfg.mrope_sections))(
        jnp.asarray(x), jnp.asarray(pos3))
    got = L.apply_mrope(_t(x), _t(pos3), cfg.rope_theta, cfg.mrope_sections)
    _close(got, want)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8)).copy()
    same = np.broadcast_to(pos[None], (3, 2, 8)).copy()
    _close(L.apply_mrope(_t(x), _t(same), cfg.rope_theta, cfg.mrope_sections),
           L.apply_rope(_t(x), _t(pos), cfg.rope_theta), 1e-5)


@pytest.mark.parametrize("chunks", [0, 2, 4])
@pytest.mark.parametrize("mlp", ["gelu", "swiglu", "relu2"])
def test_mlp_apply_matches_jax(mlp, chunks):
    jcfg = dataclasses.replace(jreduced(jget("olmo-1b")), mlp=mlp)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("olmo-1b")), mlp=mlp)
    tree = jax.tree.map(np.asarray, JP.init_params(jax.random.PRNGKey(2),
                                                   JL.mlp_defs(jcfg)))
    x = _n(9, 2, 8, jcfg.d_model)
    want = jax.jit(functools.partial(JL.mlp_apply, jcfg, ibn_chunks=chunks))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = L.mlp_apply(tcfg, TP.from_jax_params(tree, L.mlp_defs(tcfg),
                                               device="cpu"), _t(x),
                      ibn_chunks=chunks)
    _close(got, want)


def test_rms_head_norm_matches_jax():
    x, s = _n(10, 2, 4, 8, 16), _n(11, 16)
    _close(L.rms_head_norm(_t(x), _t(s)),
           JL.rms_head_norm(jnp.asarray(x), jnp.asarray(s)), 1e-5)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmo-1b", "qwen2-vl-2b"])
def test_attention_apply_matches_jax(arch):
    m = _model(arch)
    x = _n(12, 2, 40, m.jcfg.d_model)
    jb, tb = _both(_batch(m.jcfg, 0, 2, 40))
    jbp = jax.tree.map(lambda a: a[0], m.jp["blocks"]["attn"])
    tbp = TP.per_layer(m.tp["blocks"], m.tcfg.num_layers)[0]["attn"]
    _, jpos = J._embed_inputs(m.jcfg, m.jp, jb)
    _, tpos = T._embed_inputs(m.tcfg, m.tp, tb)
    want = jax.jit(functools.partial(JL.attention_apply, m.jcfg))(
        jbp, jnp.asarray(x), jpos)
    _close(L.attention_apply(m.tcfg, tbp, _t(x), tpos), want)


@pytest.mark.parametrize("case", ["linear", "clamped", "ring"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-2b"])
def test_attention_decode_apply_matches_jax(arch, case):
    """One step against a cache of 24: inside it, past it (the write clamped
    to the last slot, as the reference's dynamic_update_slice clamps), and
    on a ring (``window`` given: slot step % S)."""
    m = _model(arch)
    S, B = 24, 2
    step = {"linear": 11, "clamped": 30, "ring": 57}[case]
    window = 24 if case == "ring" else None
    x = _n(13, B, 1, m.jcfg.d_model)
    kc, vc = _n(14, B, m.jcfg.num_kv_heads, S, 16), _n(15, B, m.jcfg.num_kv_heads,
                                                      S, 16)
    jbp = jax.tree.map(lambda a: a[1], m.jp["blocks"]["attn"])
    tbp = TP.per_layer(m.tp["blocks"], m.tcfg.num_layers)[1]["attn"]
    js = jnp.array(step, jnp.int32)
    want = jax.jit(functools.partial(JL.attention_decode_apply, m.jcfg,
                                     window=window))(
        jbp, jnp.asarray(x), js, jnp.asarray(kc), jnp.asarray(vc), js)
    ts = torch.tensor(step, dtype=torch.int32)
    got = L.attention_decode_apply(m.tcfg, tbp, _t(x), ts, _t(kc), _t(vc), ts,
                                   window=window)
    for g, w in zip(got, want):
        _close(g, w)


def test_to_ring_matches_jax():
    a = _n(16, 2, 3, 45, 4)
    for w in (8, 32, 45):
        _close(T._to_ring(_t(a), w),
               jax.jit(J._to_ring, static_argnums=1)(jnp.asarray(a), w), 0)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    m = _model(arch)
    jb, tb = _both(_batch(m.jcfg, 1, 2, 40))
    jh, _ = jax.jit(functools.partial(J.forward, m.jcfg, remat=False))(m.jp, jb)
    th, aux = T.forward(m.tcfg, m.tp, tb)
    _close(th, jh)
    _close(T.logits_fn(m.tcfg, m.tp, th), J.logits_fn(m.jcfg, m.jp, jh))
    assert float(aux) == 0.0


# (batch, prompt length, decode steps): the prompt-sized cache is decoded
# past (every step's write clamped to its last slot); h2o-danube's 48-token
# prompt is longer than its reduced window of 32, which gives the banded
# prefill and a ring cache
_PREFILL = {"h2o-danube-1.8b": (2, 48, 6), "olmo-1b": (2, 20, 5),
            "minitron-4b": (1, 33, 4), "starcoder2-15b": (2, 17, 4),
            "qwen2-vl-2b": (2, 24, 4)}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    m = _model(arch)
    B, S, n = _PREFILL[arch]
    jb, tb = _both(_batch(m.jcfg, 2, B, S))
    jlast, jc = m.jprefill(m.jp, jb)
    tlast, tc = T.prefill(m.tcfg, m.tp, tb)
    W = T.cache_len(m.tcfg, S)
    assert tuple(tc.k.shape) == (m.tcfg.num_layers, B, m.tcfg.num_kv_heads, W,
                                 m.tcfg.head_dim) == tuple(jc.k.shape)
    assert tc.step.dtype == torch.int32 and int(tc.step) == S
    _close(tlast, jlast)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    toks = np.random.default_rng(3).integers(0, m.jcfg.vocab_size, (B, n),
                                             dtype=np.int32)
    for i in range(n):
        jl, jc = m.jdecode(m.jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tl, tc = T.decode_step(m.tcfg, m.tp, tc, {"tokens": _t(toks[:, i:i + 1])})
        _close(tl, jl)
        _close(tc.k, jc.k)
        assert int(tc.step) == int(jc.step) == S + i + 1


def test_decode_matches_forward_dense():
    """Stepwise decode logits == teacher-forced forward logits (olmo), on a
    cache grown to the whole sequence first (port of the reference's
    ``test_decode_matches_forward_dense``)."""
    m = _model("olmo-1b")
    Tn = 16
    toks = _t(np.random.default_rng(5).integers(0, m.tcfg.vocab_size, (1, Tn),
                                                dtype=np.int32))
    hidden, _ = T.forward(m.tcfg, m.tp, {"tokens": toks}, kernels=tref.PLAIN)
    full = T.logits_fn(m.tcfg, m.tp, hidden)
    prefix = Tn // 2
    _, cache = T.prefill(m.tcfg, m.tp, {"tokens": toks[:, :prefix]})
    grown = T.init_cache(m.tcfg, 1, Tn, device="cpu")
    cache = T.Cache(k=grown.k.index_copy(3, torch.arange(prefix), cache.k),
                    v=grown.v.index_copy(3, torch.arange(prefix), cache.v),
                    step=cache.step)
    for t in range(prefix, Tn):
        logits, cache = T.decode_step(m.tcfg, m.tp, cache,
                                      {"tokens": toks[:, t:t + 1]})
        _close(logits[0], full[0, t], 2e-3)


def test_prompts_go_through_the_kernel_once_a_layer_and_decode_never():
    m = _model("h2o-danube-1.8b")
    n = {"flash_attention": 0}

    def fa(q, k, v, **kw):
        n["flash_attention"] += 1
        return tref.attention_ref(q, k, v, **kw)

    kern = types.SimpleNamespace(flash_attention=fa)
    tb = {"tokens": _t(_batch(m.jcfg, 4, 1, 40)["tokens"])}      # banded (40 > 32)
    _, cache = build_prefill_step(m.tcfg, kernels=kern)(m.tp, tb)
    assert n == T.kernel_launches_per_prefill(m.tcfg) == {"flash_attention": 2}
    build_decode_step(m.tcfg, kernels=kern)(m.tp, cache, {"tokens": tb["tokens"][:, :1]})
    T.forward(m.tcfg, m.tp, tb, kernels=kern)
    assert n["flash_attention"] == 4


def test_donated_decode_chain_equals_the_functional_one():
    """``donating(decode, 1)`` (the captured decode's form) gives the
    functional steps' tokens, logits and caches bit for bit, on a ring."""
    m = _model("h2o-danube-1.8b")
    tb = {"tokens": _t(_batch(m.jcfg, 6, 2, 40)["tokens"])}
    prefill, decode = build_prefill_step(m.tcfg), build_decode_step(m.tcfg)
    donated = donating(decode, 1)
    _, c1 = prefill(m.tp, tb)
    _, c2 = prefill(m.tp, tb)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for _ in range(5):
        t1, l1, c1 = decode(m.tp, c1, {"tokens": tok})
        t2, l2, c2b = donated(m.tp, c2, {"tokens": tok})
        assert c2b is c2
        for a, b in zip((t1, l1, *c1), (t2, l2, *c2)):
            assert torch.equal(a, b)
        tok = t1[:, None]


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,S", [("h2o-danube-1.8b", 40), ("qwen2-vl-2b", 12),
                                    ("recurrentgemma-2b", 40)])
def test_serve_on_cpu_gives_the_jax_greedy_tokens(arch, S, capsys):
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", str(S), "--gen", "6",
                       "--seed", "3"])
    printed = capsys.readouterr().out
    assert f"prefill[2x{S}]" in printed and "ms/tok" in printed
    assert out["tokens"].shape == (2, 6)

    # the same run on the JAX package: the port's seeded weights and
    # prompts, the JAX launcher's prefill and greedy decode loop
    jcfg = jreduced(jget(arch))
    tcfg = TC.reduced(TC.get_config(arch))
    tree = TP.init_params(3, get_module(tcfg).param_defs(tcfg))
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, S),
                                                dtype=np.int32))}
    if jcfg.embedding_inputs:
        batch["inputs_embeds"] = jnp.asarray(rng.standard_normal(
            (2, S, jcfg.d_model)).astype(np.float32))
    _, cache = jax.jit(j_prefill_step(jcfg))(jp, batch)
    decode = jax.jit(j_decode_step(jcfg))
    tok, toks = jnp.zeros((2, 1), jnp.int32), []
    for _ in range(6):
        tok1, _, cache = decode(jp, cache, {"tokens": tok})
        tok = tok1[:, None]
        toks.append(np.asarray(tok1))
    np.testing.assert_array_equal(out["tokens"], np.stack(toks, 1))


def test_transformer_modules_load_no_jax_and_build_nothing():
    code = ("import sys; import repro_torch.models.transformer, "
            "repro_torch.models.attention, repro_torch.launch.serve; "
            "from repro_torch.kernels import _build; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'jax or repro imported'; "
            "assert _build.build_seconds is None")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)
