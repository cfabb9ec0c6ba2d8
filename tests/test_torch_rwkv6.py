"""The port's RWKV-6 slice against the JAX package, on the CPU.

Everything runs at ``reduced(rwkv6-1.6b)`` (d 64, 2 layers, 4 heads of 16,
chunk 8, float32).  Weights come from ``repro.models.params.init_params``,
are turned to numpy and carried across by ``rwkv6.load_params``; tokens
and WKV operands are numpy arrays from a seed.  Tolerance 2e-4, the JAX
WKV tests' own: float32 sums taken in another order (the port's prompt
path is the per-token ``wkv_ref`` on the CPU, the JAX one its chunked
form), through two layers.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import params as JP
from repro.models import rwkv6 as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import get_module
from repro_torch.models import params as TP
from repro_torch.models import rwkv6 as R
from repro_torch.runtime import build_decode_step, build_prefill_step

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def red():
    jcfg = jreduced(jget("rwkv6-1.6b"))
    tcfg = TC.reduced(TC.get_config("rwkv6-1.6b"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JP.init_params(jax.random.PRNGKey(0), J.param_defs(jcfg)))
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree,
                jp=jax.tree.map(jnp.asarray, tree),
                tp=R.load_params(tcfg, tree, device="cpu"))


def _wkv_operands(seed, B, T, H, K, *, state=False):
    r = np.random.default_rng(seed)
    n = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    out = [n(B, T, H, K), n(B, T, H, K), n(B, T, H, K),
           (-np.exp(r.standard_normal((B, T, H, K)) * 0.5)).astype(np.float32),
           n(H, K)]
    out.append(n(B, H, K, K) if state else np.zeros((B, H, K, K), np.float32))
    return out


# ---------------------------------------------------------------------------
# configuration, registry, parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_is_a_faithful_copy(which):
    a, b = jget("rwkv6-1.6b"), TC.get_config("rwkv6-1.6b")
    if which == "reduced":
        a, b = jreduced(a), TC.reduced(b)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.compute_dtype == getattr(torch, a.dtype)
    assert b.params_dtype == torch.float32 and b.padded_vocab == a.padded_vocab


def test_registry_names_the_roadmap_item_of_what_is_not_ported():
    assert set(TC.ARCHS) | set(TC.NOT_PORTED) == set(JARCHS)
    assert not set(TC.ARCHS) & set(TC.NOT_PORTED)
    for name in TC.NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP"):
            TC.get_config(name)
    with pytest.raises(KeyError, match="unknown"):
        TC.get_config("rwkv7")
    assert get_module(TC.get_config("rwkv6-1.6b")) is R
    for family in ("dense", "vlm", "moe"):
        cfg = dataclasses.replace(TC.get_config("rwkv6-1.6b"), family=family)
        assert get_module(cfg).__name__ == "repro_torch.models.transformer"
    cfg = dataclasses.replace(TC.get_config("rwkv6-1.6b"), family="audio")
    assert get_module(cfg).__name__ == "repro_torch.models.seamless"
    cfg = dataclasses.replace(TC.get_config("rwkv6-1.6b"), family="hybrid")
    assert get_module(cfg).__name__ == "repro_torch.models.recurrentgemma"
    assert not TC.NOT_PORTED


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_param_defs_match_jax(which):
    jcfg, tcfg = jget("rwkv6-1.6b"), TC.get_config("rwkv6-1.6b")
    if which == "reduced":
        jcfg, tcfg = jreduced(jcfg), TC.reduced(tcfg)
    a, b = J.param_defs(jcfg), R.param_defs(tcfg)
    flat_a = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  a, is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]}
    flat_b = {}
    TP.tree_map(lambda d, path: flat_b.__setitem__(path, d), b)
    norm = lambda k: re.sub(r"\['?([^'\]]+)'?\]", r".\1", k).lstrip(".")  # noqa: E731
    assert {norm(k) for k in flat_a} == set(flat_b)
    for k, d in flat_a.items():
        e = flat_b[norm(k)]
        assert (tuple(d.shape), d.init, d.scale) == (tuple(e.shape), e.init,
                                                     e.scale), k
    assert TP.count_params(b) == JP.count_params(a)
    if which == "CONFIG":
        assert TP.count_params(b) == 1_599_873_024


def test_init_params_embed_and_uniform_decay(red):
    defs = R.param_defs(red["tcfg"])
    a, b = TP.init_params(5, defs), TP.init_params(5, defs)
    assert all(np.array_equal(x, y) for x, y in
               zip(TP.tree_leaves(a), TP.tree_leaves(b)))
    decay = a["blocks"]["tm"]["decay"]
    assert decay.dtype == np.float32 and decay.min() > -6 and decay.max() < -3
    assert abs(decay.mean() + 4.5) < 0.2                 # -6 + 3 U(0, 1)
    emb = a["embed"]["embedding"]
    assert abs(emb.std() - 1.0) < 0.05                    # embed: scale 1
    unemb = a["embed"]["unembed"]
    assert abs(unemb.std() * np.sqrt(unemb.shape[0]) - 1) < 0.1


def test_load_params_casts_what_jax_casts_at_each_use(red):
    bf = R.load_params(dataclasses.replace(red["tcfg"], dtype="bfloat16"),
                       red["tree"], device="cpu")
    cast = set(R.COMPUTE_DTYPE_LEAVES)
    seen = []
    TP.tree_map(lambda t, path: seen.append((path, t.dtype)), bf)
    for path, dt in seen:
        assert dt == (torch.bfloat16 if path in cast else torch.float32), path
    assert cast <= {p for p, _ in seen}
    assert bf["blocks"]["tm"]["td_w2"].dtype == torch.float32      # read in f32
    assert bf["embed"]["unembed"].dtype == torch.float32


def test_entry_points_default_to_the_card_and_raise_without_one(red):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        R.load_params(red["tcfg"], red["tree"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--arch", "rwkv6-1.6b", "--reduced"])


# ---------------------------------------------------------------------------
# the WKV core against JAX and against the kernel route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk,state", [(32, 8, False), (32, 8, True),
                                           (50, 16, True), (12, 64, True)])
def test_wkv_chunked_model_form_matches_jax(T, chunk, state):
    r, k, v, w, u, s0 = _wkv_operands(1, 2, T, 2, 8, state=state)
    want_o, want_s = J.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)), chunk=chunk)
    got_o, got_s = R.wkv_chunked(*map(_t, (r, k, v, w, u, s0)), chunk=chunk)
    _close(got_o.numpy(), want_o)
    _close(got_s.numpy(), want_s)


def test_wkv_recurrent_step_matches_jax():
    r, k, v, w, u, s0 = _wkv_operands(2, 3, 1, 2, 8, state=True)
    want_o, want_s = J.wkv_recurrent_step(*map(jnp.asarray, (r[:, 0], k[:, 0], v[:, 0],
                                                            w[:, 0], u, s0)))
    got_o, got_s = R.wkv_recurrent_step(*map(_t, (r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                                  u, s0)))
    _close(got_o.numpy(), want_o)
    _close(got_s.numpy(), want_s)


def test_kernel_route_matches_model_wkv():
    """``ops.wkv_chunked`` on the [B*H, T, K] layout (with u repeated over
    the batch) equals the model's chunked form from a zero state, ragged T
    included (the port of tests/test_scan.py::test_kernel_matches_model_wkv)."""
    r, k, v, w, u, s0 = _wkv_operands(7, 2, 50, 2, 8)
    want_o, want_s = R.wkv_chunked(*map(_t, (r, k, v, w, u, s0)), chunk=16)
    got_o, got_s = R._wkv_kernel(tops, *map(_t, (r, k, v, w, u)), chunk=16)
    _close(got_o.numpy(), want_o.numpy())
    _close(got_s.numpy(), want_s.numpy())


# ---------------------------------------------------------------------------
# model entry points against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [11, 16])
def test_forward_matches_jax(red, T):
    toks = np.random.default_rng(T).integers(0, 256, (2, T), dtype=np.int32)
    want, _ = J.forward(red["jcfg"], red["jp"], {"tokens": jnp.asarray(toks)},
                        remat=False)
    got, aux = R.forward(red["tcfg"], red["tp"], {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got.numpy(), want)
    _close(R.logits_fn(red["tcfg"], red["tp"], got).numpy(),
           J.logits_fn(red["jcfg"], red["jp"], want))


def test_prefill_and_decode_match_jax(red):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 13), dtype=np.int32)
    lj, cj = J.prefill(red["jcfg"], red["jp"], {"tokens": jnp.asarray(toks)})
    lt, ct = R.prefill(red["tcfg"], red["tp"], {"tokens": _t(toks)})
    _close(lt.numpy(), lj)
    for name in ("state", "shift_tm", "shift_cm"):
        a, b = getattr(cj, name), getattr(ct, name)
        assert tuple(a.shape) == tuple(b.shape), name
        _close(b.numpy(), a)
    assert int(ct.step) == int(cj.step) == 13
    for _ in range(4):
        tk = rng.integers(0, 256, (2, 1), dtype=np.int32)
        gj, cj = J.decode_step(red["jcfg"], red["jp"], cj, {"tokens": jnp.asarray(tk)})
        gt, ct = R.decode_step(red["tcfg"], red["tp"], ct, {"tokens": _t(tk)})
        _close(gt.numpy(), gj)
    assert int(ct.step) == 17


def test_decode_matches_forward(red):
    """Recurrent decode after a prefill equals the chunked forward (the
    port of tests/test_arch_smoke.py::test_decode_matches_forward_rwkv,
    at its tolerance, 2e-3)."""
    cfg, p = red["tcfg"], red["tp"]
    toks = _t(np.random.default_rng(5).integers(0, 256, (1, 12), dtype=np.int32))
    hidden, _ = R.forward(cfg, p, {"tokens": toks})
    full = R.logits_fn(cfg, p, hidden)
    _, cache = R.prefill(cfg, p, {"tokens": toks[:, :6]})
    for t in range(6, 12):
        logits, cache = R.decode_step(cfg, p, cache, {"tokens": toks[:, t:t + 1]})
        _close(logits[0].numpy(), full[0, t].numpy(), 2e-3)


def test_init_cache_is_the_zero_start(red):
    cfg, p = red["tcfg"], red["tp"]
    toks = _t(np.random.default_rng(6).integers(0, 256, (2, 1), dtype=np.int32))
    cache = R.init_cache(cfg, 2, 64, device="cpu")
    assert tuple(cache.state.shape) == (2, 2, 4, 16, 16)
    logits, _ = R.decode_step(cfg, p, cache, {"tokens": toks})
    hidden, _ = R.forward(cfg, p, {"tokens": toks})
    _close(logits.numpy(), R.logits_fn(cfg, p, hidden)[:, 0].numpy())


class _Recorder:
    """A kernel namespace that records the ``wkv_chunked`` calls and runs
    the plain version."""

    def __init__(self):
        self.calls = []

    def wkv_chunked(self, r, k, v, logw, u, *, chunk=64):
        # the CUDA wrapper takes dense operands only
        assert all(t.is_contiguous() for t in (r, k, v, logw, u))
        self.calls.append((tuple(r.shape), tuple(v.shape), tuple(u.shape), chunk))
        return tref.wkv_ref(r, k, v, logw, u)


@pytest.mark.parametrize("B", [3, 1])
def test_prompts_go_through_the_kernel_once_a_layer_and_decode_never(red, B):
    cfg, p = red["tcfg"], red["tp"]
    rec = _Recorder()
    toks = _t(np.random.default_rng(8).integers(0, 256, (B, 10), dtype=np.int32))
    _, cache = R.prefill(cfg, p, {"tokens": toks}, kernels=rec)
    assert rec.calls == [((4 * B, 10, 16), (4 * B, 10, 16), (4 * B, 16), 8)] * 2
    R.decode_step(cfg, p, cache, {"tokens": toks[:, :1]}, kernels=rec)
    assert len(rec.calls) == 2
    assert R.kernel_launches_per_prefill(cfg) == {"wkv_chunked": 2}
    assert R.kernel_launches_per_prefill(TC.get_config("rwkv6-1.6b")) == {
        "wkv_chunked": 24}


def test_time_mix_refuses_a_prompt_from_a_nonzero_state(red):
    """A prompt (T > 1) from a given state no longer raises: the chunked
    kernel starts from it, as the reference's ``wkv_chunked(..., state,
    chunk)`` does (``tests/test_torch_cp.py`` holds it to JAX).  Here: from
    a nonzero state, the output and the final state equal four one-token
    steps from the same state (the decode recurrence), and a zero state
    gives what the zero start (None) gives."""
    cfg, p = red["tcfg"], red["tp"]
    tm = {k: v[0] for k, v in p["blocks"]["tm"].items()}
    g = np.random.default_rng(9)
    x = _t(g.standard_normal((1, 4, 64)).astype(np.float32))
    prev = torch.zeros(1, 64)
    out, _, _ = R.time_mix(cfg, tm, x, prev, torch.zeros(1, 4, 16, 16), 8)
    _close(out.numpy(), R.time_mix(cfg, tm, x, prev, None, 8)[0].numpy())
    s0 = _t(g.standard_normal((1, 4, 16, 16)).astype(np.float32))
    out, _, state = R.time_mix(cfg, tm, x, prev, s0, 8)
    steps, s, xp = [], s0, prev
    for t in range(4):
        o, xp, s = R.time_mix(cfg, tm, x[:, t:t + 1], xp, s, 8)
        steps.append(o)
    _close(out.numpy(), torch.cat(steps, 1).numpy())
    _close(state.numpy(), s.numpy())


# ---------------------------------------------------------------------------
# runtime steps and the serving launcher
# ---------------------------------------------------------------------------


def test_decode_step_masks_the_padded_vocabulary(red):
    cfg = dataclasses.replace(red["tcfg"], vocab_size=250)
    p = dict(red["tp"])
    unembed = p["embed"]["unembed"].clone()
    unembed[:, 250:] = 1e3                   # padded columns would win the argmax
    p["embed"] = {"embedding": p["embed"]["embedding"], "unembed": unembed}
    toks = _t(np.random.default_rng(9).integers(0, 250, (2, 5), dtype=np.int32))
    _, cache = build_prefill_step(cfg)(p, {"tokens": toks})
    tok, logits, _ = build_decode_step(cfg)(p, cache, {"tokens": toks[:, :1]})
    assert tok.dtype == torch.int32 and bool((tok < 250).all())
    assert bool(torch.isinf(logits[:, 250:]).all())


def test_serve_on_cpu_gives_the_jax_greedy_tokens(red, capsys):
    out = tserve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "6",
                       "--seed", "3"])
    printed = capsys.readouterr().out
    assert "prefill[2x12]" in printed and "ms/tok" in printed
    assert out["tokens"].shape == (2, 6)

    # the same run on the JAX package: the port's seeded weights and prompts
    jcfg = red["jcfg"]
    tree = TP.init_params(3, R.param_defs(red["tcfg"]))
    jp = jax.tree.map(jnp.asarray, tree)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12),
                                                dtype=np.int32)
    _, cache = j_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(prompts)})
    decode = j_decode_step(jcfg)
    tok, toks = jnp.zeros((2, 1), jnp.int32), []
    for _ in range(6):
        tok1, _, cache = decode(jp, cache, {"tokens": tok})
        tok = tok1[:, None]
        toks.append(np.asarray(tok1))
    np.testing.assert_array_equal(out["tokens"], np.stack(toks, 1))


def test_rwkv_modules_load_no_jax_and_build_nothing():
    code = ("import sys; import repro_torch.models.rwkv6, repro_torch.launch.serve, "
            "repro_torch.runtime, repro_torch.kernels._build as b; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert b._lib is None and b.build_seconds is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
