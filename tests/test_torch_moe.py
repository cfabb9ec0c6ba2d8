"""The port's MoE block and MoE transformer against the JAX package, on the CPU.

Everything runs at ``reduced(...)`` size (2 layers, d 64, 4 heads of 16,
4 experts of 32 with top-2 routing, float32) for ``qwen2-moe-a2.7b`` (one
shared expert behind a sigmoid gate, top-k unnormalised) and
``qwen3-moe-30b-a3b`` (QK-norm, GQA, top-k normalised).  Weights come from
``repro.models.params.init_params``, are turned to numpy and carried across
by ``transformer.load_params``.  Tolerance 2e-4, as in the JAX tests; the
expert choices must be JAX's exactly (``lax.top_k`` on the reference's
probabilities), ties at the k-th place and padded experts included.  The
whole file takes ~15 s, most of it JAX's compiles.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import get_module
from repro_torch.models import layers as L
from repro_torch.models import params as TP
from repro_torch.models import transformer as T
from repro_torch.runtime import build_decode_step, build_prefill_step

TOL = 2e-4
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
# parameter counts of the uncut configurations, as the JAX package counts
# them (the routed experts padded, 60 -> 64 for qwen2-moe)
FULL_PARAMS = {"qwen2-moe-a2.7b": 15_146_305_536,
               "qwen3-moe-30b-a3b": 30_532_122_624}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_cfgs(arch="qwen3-moe-30b-a3b", e=4, pad=0, top_k=2):
    """The reduced config of ``arch`` with ``e`` real experts padded by
    ``pad``, on both sides (as ``tests/test_models_internal.py`` sets it)."""
    out = []
    for cfg in (jreduced(jget(arch)), TC.reduced(TC.get_config(arch))):
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=top_k, num_experts=e, num_experts_padded=e + pad)))
    return out


def _moe_tree(jcfg, seed=3):
    return jax.tree.map(np.asarray, JP.init_params(jax.random.PRNGKey(seed),
                                                   JL.moe_defs(jcfg)))


def _jax_choices(jcfg, tree, x):
    """The reference's expert indices for ``x``: the first lines of its
    ``moe_apply`` (router product, pad mask, softmax, ``lax.top_k``)."""
    m = jcfg.moe
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    logits = (xt @ jnp.asarray(tree["router"])).astype(jnp.float32)
    pad = jnp.arange(m.num_experts_padded) >= m.num_experts
    probs = jax.nn.softmax(jnp.where(pad[None], -1e30, logits), axis=-1)
    return np.asarray(jax.lax.top_k(probs, m.top_k)[1])


def _moe_both(jcfg, tcfg, tree, x, capacity_factor=1.25):
    """(JAX (out, aux), port (out, aux), port's expert indices)."""
    want = jax.jit(functools.partial(JL.moe_apply, jcfg,
                                     capacity_factor=capacity_factor))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = TP.from_jax_params(tree, L.moe_defs(tcfg), device="cpu")
    got = L.moe_apply(tcfg, tp, _t(x), capacity_factor=capacity_factor)
    _, _, idx = L.moe_route(tcfg, tp["router"], _t(x).reshape(-1, tcfg.d_model))
    return want, got, idx.numpy()


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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_jax(arch):
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    jdefs = jax.tree_util.tree_flatten_with_path(
        J.param_defs(jcfg), is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path):
            (tuple(d.shape), d.init, d.scale) for path, d in jdefs}
    got = {}
    TP.tree_map(lambda d, path: got.__setitem__(path, (tuple(d.shape), d.init,
                                                       d.scale)),
                T.param_defs(tcfg))
    assert got == want
    assert TP.count_params(T.param_defs(tcfg)) == JP.count_params(
        J.param_defs(jcfg)) == FULL_PARAMS[arch]


def test_load_params_casts_the_moe_leaves_jax_casts_at_each_use():
    """The router, the experts, the shared experts and their gate go to the
    compute dtype; norm scales and the unembedding stay float32."""
    jcfg = jreduced(jget("qwen2-moe-a2.7b"))
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("qwen2-moe-a2.7b")),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JP.init_params(jax.random.PRNGKey(0),
                                                   J.param_defs(jcfg)))
    p = T.load_params(tcfg, tree, device="cpu")
    moe = [path for path in T.COMPUTE_DTYPE_LEAVES if path.startswith("blocks.moe")]
    assert len(moe) == 8
    for path in moe:
        node = p
        for key in path.split("."):
            node = node[key]
        assert node.dtype == torch.bfloat16, path
    assert p["embed"]["unembed"].dtype == torch.float32
    assert p["blocks"]["ln2"]["scale"].dtype == torch.float32
    assert "mlp" not in p["blocks"]


# ---------------------------------------------------------------------------
# the MoE block (ports of tests/test_models_internal.py's MoE tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [0.1, 1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, capacity_factor):
    """Output and aux loss; at 0.1 most claims are dropped (capacity 3 of
    the 64 tokens' 128 claims over 4 experts), at 4.0 none."""
    jcfg, tcfg = _moe_cfgs(arch)
    tree = _moe_tree(jcfg)
    x = _n(2, 2, 32, jcfg.d_model)
    (jout, jaux), (tout, taux), idx = _moe_both(jcfg, tcfg, tree, x,
                                                capacity_factor)
    np.testing.assert_array_equal(idx, _jax_choices(jcfg, tree, x))
    _close(tout, jout)
    _close(taux, jaux)
    assert np.isfinite(tout.numpy()).all() and 0.0 <= float(taux) < 4


def test_moe_capacity_drops_tokens():
    """As in the reference: a small capacity factor zeroes the dropped
    claims' share, so the output shrinks but stays finite."""
    _, tcfg = _moe_cfgs()
    tp = TP.from_jax_params(_moe_tree(_moe_cfgs()[0]), L.moe_defs(tcfg),
                            device="cpu")
    x = _t(_n(4, 1, 64, tcfg.d_model))
    hi, _ = L.moe_apply(tcfg, tp, x, capacity_factor=4.0)
    lo, _ = L.moe_apply(tcfg, tp, x, capacity_factor=0.1)
    assert torch.isfinite(lo).all()
    assert float(lo.abs().mean()) < float(hi.abs().mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_padded_experts_unused(arch):
    """3 real experts padded to 4: no claim goes to the padded one, the aux
    loss counts the real ones only, and the output is JAX's."""
    jcfg, tcfg = _moe_cfgs(arch, e=3, pad=1)
    tree = _moe_tree(jcfg)
    x = _n(5, 2, 32, jcfg.d_model)
    (jout, jaux), (tout, taux), idx = _moe_both(jcfg, tcfg, tree, x)
    assert (idx < 3).all()
    np.testing.assert_array_equal(idx, _jax_choices(jcfg, tree, x))
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tied_router_goes_to_the_lower_expert(arch):
    """Router columns 1 and 2 equal: every token's probabilities of experts
    1 and 2 tie exactly, and where the pair straddles the k-th place the
    lower index must win, as ``lax.top_k`` picks it.  The tied experts'
    weights differ, so a wrong pick also moves the output."""
    jcfg, tcfg = _moe_cfgs(arch)
    tree = _moe_tree(jcfg)
    r = tree["router"].copy()
    r[:, 2] = r[:, 1]
    tree = dict(tree, router=r)
    x = _n(6, 2, 32, jcfg.d_model)
    (jout, jaux), (tout, taux), idx = _moe_both(jcfg, tcfg, tree, x)
    probs, _, _ = L.moe_route(tcfg, _t(r), _t(x).reshape(-1, tcfg.d_model))
    assert torch.equal(probs[:, 1], probs[:, 2])          # the ties are exact
    np.testing.assert_array_equal(idx, _jax_choices(jcfg, tree, x))
    chose = [set(row) for row in idx.tolist()]
    assert all(1 in c for c in chose if 2 in c)
    straddled = sum(1 for c in chose if 1 in c and 2 not in c)
    assert straddled > 0, "no token had the tie at the k-th place"
    _close(tout, jout)
    _close(taux, jaux)


# ---------------------------------------------------------------------------
# the model: forward, prefill, greedy decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_gradients_match_jax_grad(arch, capacity_factor):
    """The backward of the dispatch and the combine: the gradients of
    sum(out * w) + aux with respect to x and every leaf (router, the
    experts' wi / wg / wo, the shared expert and its gate) against
    ``jax.grad`` of the reference's ``moe_apply``, within 2e-4; at 0.5 some
    claims are dropped (capacity 16 of 64 tokens' 128 claims over 4
    experts), at 4.0 none."""
    jcfg, tcfg = _moe_cfgs(arch)
    tree = _moe_tree(jcfg)
    x = _n(7, 2, 32, jcfg.d_model)
    w = _n(8, 2, 32, jcfg.d_model)

    def jloss(p, xx):
        out, aux = JL.moe_apply(jcfg, p, xx, capacity_factor=capacity_factor)
        return jnp.sum(out * jnp.asarray(w)) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = TP.from_jax_params(tree, L.moe_defs(tcfg), device="cpu")
    leaves = [t.requires_grad_() for t in TP.tree_leaves(tp)]
    xt = _t(x).requires_grad_()
    out, aux = L.moe_apply(tcfg, tp, xt, capacity_factor=capacity_factor)
    _, _, idx = L.moe_route(tcfg, tp["router"], xt.reshape(-1, tcfg.d_model))
    kept = L.moe_apply(tcfg, tp, xt, capacity_factor=4.0)[0]
    assert (capacity_factor < 1) == (not torch.equal(out, kept))   # drops at 0.5
    grads = torch.autograd.grad(torch.sum(out * _t(w)) + aux, [xt] + leaves)
    np.testing.assert_array_equal(idx.numpy(), _jax_choices(jcfg, tree, x))
    _close(grads[0].numpy(), jgx)
    want = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    names = []
    TP.tree_map(lambda leaf, path: names.append(path), tp)
    assert sorted(names) == sorted(want) and {"router", "wi", "wo"} <= set(names)
    for name, g in zip(names, grads[1:]):
        assert float(g.abs().max()) > 0, name
        _close(g.numpy(), want[name])


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jreduced(jget(arch))
        tcfg = TC.reduced(TC.get_config(arch))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
            lambda key: JP.init_params(key, J.param_defs(jcfg)))(
                jax.random.PRNGKey(0)))
        _MODELS[arch] = types.SimpleNamespace(
            jcfg=jcfg, tcfg=tcfg, tree=tree, jp=jax.tree.map(jnp.asarray, tree),
            tp=T.load_params(tcfg, tree, device="cpu"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    m = _model(arch)
    toks = np.random.default_rng(1).integers(0, m.jcfg.vocab_size, (2, 24),
                                             dtype=np.int32)
    jh, jaux = jax.jit(functools.partial(J.forward, m.jcfg, remat=False))(
        m.jp, {"tokens": jnp.asarray(toks)})
    th, taux = T.forward(m.tcfg, m.tp, {"tokens": _t(toks)})
    _close(th, jh)
    _close(taux, jaux)
    assert float(taux) > 0
    _close(T.logits_fn(m.tcfg, m.tp, th), J.logits_fn(m.jcfg, m.jp, jh))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax_steps(arch):
    """The port's step builders against JAX's ``build_prefill_step`` /
    ``build_decode_step`` under ``jax.jit``: last hidden, cache, then 5
    greedy steps from token 0 (tokens equal, logits and caches within
    tolerance).  At B = 2 a decode step's 4 claims over 4 experts give
    capacity 1, so two tokens that pick one expert drop a claim, as in the
    reference."""
    m = _model(arch)
    B, S = 2, 20
    toks = np.random.default_rng(2).integers(0, m.jcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jlast, jc = jax.jit(j_prefill_step(m.jcfg))(m.jp, {"tokens": jnp.asarray(toks)})
    tlast, tc = build_prefill_step(m.tcfg)(m.tp, {"tokens": _t(toks)})
    _close(tlast, jlast)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    jdec, tdec = jax.jit(j_decode_step(m.jcfg)), build_decode_step(m.tcfg)
    jtok, ttok = jnp.zeros((B, 1), jnp.int32), torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(5):
        j1, jl, jc = jdec(m.jp, jc, {"tokens": jtok})
        t1, tl, tc = tdec(m.tp, tc, {"tokens": ttok})
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        _close(tl[:, :m.tcfg.vocab_size], jl[:, :m.jcfg.vocab_size])
        _close(tc.k, jc.k)
        jtok, ttok = j1[:, None], t1[:, None]


def test_moe_prompts_go_through_the_kernel_once_a_layer_and_decode_never():
    m = _model("qwen2-moe-a2.7b")
    n = {"flash_attention": 0}

    def fa(q, k, v, **kw):
        n["flash_attention"] += 1
        return tref.attention_ref(q, k, v, **kw)

    kern = types.SimpleNamespace(flash_attention=fa)
    tb = {"tokens": torch.zeros((1, 12), dtype=torch.int32)}
    _, cache = build_prefill_step(m.tcfg, kernels=kern)(m.tp, tb)
    assert n == T.kernel_launches_per_prefill(m.tcfg) == {"flash_attention": 2}
    build_decode_step(m.tcfg, kernels=kern)(m.tp, cache, {"tokens": tb["tokens"][:, :1]})
    assert n["flash_attention"] == 2


def test_serve_on_cpu_gives_the_jax_greedy_tokens(capsys):
    out = tserve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "5",
                       "--seed", "4"])
    assert "prefill[2x12]" in capsys.readouterr().out
    jcfg = jreduced(jget("qwen2-moe-a2.7b"))
    tree = TP.init_params(4, T.param_defs(TC.reduced(TC.get_config("qwen2-moe-a2.7b"))))
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(4)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 12),
                                                dtype=np.int32))}
    _, cache = jax.jit(j_prefill_step(jcfg, decode_len=17))(jp, batch)
    decode = jax.jit(j_decode_step(jcfg))
    tok, toks = jnp.zeros((2, 1), jnp.int32), []
    for _ in range(5):
        tok1, _, cache = decode(jp, cache, {"tokens": tok})
        tok = tok1[:, None]
        toks.append(np.asarray(tok1))
    np.testing.assert_array_equal(out["tokens"], np.stack(toks, 1))
