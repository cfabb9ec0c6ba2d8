"""``repro_torch.runtime.capture`` on the CPU.

``donating`` is the port of ``jax.jit(decode, donate_argnums=(1,))``: here a
donated decode chain is held to the functional chain of the port (bit for
bit) and to the reference's own served form, a jitted prefill and a jitted
decode step with its cache donated (tokens equal, logits within 2e-3, the
tolerance of the port's decode-vs-forward test: float32 sums in another
order through two layers and eight steps).  ``captured`` and
``captured_train_step`` run on the card only; here they must refuse CPU
tensors (and the train step's wrapper a mesh whose collectives cross
ranks).  Its captures and replays are
``tests/test_torch_cuda.py``'s.  Everything at ``reduced(rwkv6-1.6b)``
with weights from ``repro.models.params.init_params``.
"""
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
from repro.models import rwkv6 as J
from repro.runtime import build_decode_step as j_decode_step
from repro.runtime import build_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.models import rwkv6 as R
from repro_torch.optim import adamw_init
from repro_torch.runtime import (build_decode_step, build_prefill_step,
                                 captured, captured_train_step, donating)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


@pytest.fixture(scope="module")
def red():
    jcfg = jreduced(jget("rwkv6-1.6b"))
    tcfg = TC.reduced(TC.get_config("rwkv6-1.6b"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JP.init_params(jax.random.PRNGKey(0), J.param_defs(jcfg)))
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 12),
                                                 dtype=np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, tree),
                tp=R.load_params(tcfg, tree, device="cpu"), prompts=prompts)


def _donated_run(red):
    """The prompts' prefill, then STEPS greedy steps of the donated decode
    and of the functional one side by side; asserts they agree bit for bit
    at every step and that the donated step returns its argument."""
    cfg, p = red["tcfg"], red["tp"]
    _, cache = build_prefill_step(cfg)(p, {"tokens": torch.from_numpy(red["prompts"])})
    decode = build_decode_step(cfg)
    step = donating(decode, 1)
    buf = R.RWKVCache(*(t.clone() for t in cache))
    held = list(buf)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    toks, logits = [], []
    for _ in range(STEPS):
        t_fun, lg_fun, cache = decode(p, cache, {"tokens": tok})
        t_don, lg_don, out = step(p, buf, {"tokens": tok})
        assert out is buf and all(a is b for a, b in zip(out, held))
        assert torch.equal(t_don, t_fun) and torch.equal(lg_don, lg_fun)
        for a, b in zip(buf, cache):
            assert a.dtype == b.dtype and torch.equal(a, b)
        tok = t_don[:, None]
        toks.append(t_don)
        logits.append(lg_don)
    assert int(buf.step) == red["prompts"].shape[1] + STEPS
    return torch.stack(toks, 1).numpy(), torch.stack(logits, 1).numpy()


def test_donated_decode_is_the_functional_chain_and_the_jitted_donating_one(red):
    toks, logits = _donated_run(red)

    # the reference's served form: jit(prefill), then jit(decode,
    # donate_argnums=(1,)) fed its own greedy tokens
    jcfg = red["jcfg"]
    _, cache = jax.jit(j_prefill_step(jcfg))(
        red["jp"], {"tokens": jnp.asarray(red["prompts"])})
    decode = jax.jit(j_decode_step(jcfg), donate_argnums=(1,))
    tok, jtoks, jlogits = jnp.zeros((2, 1), jnp.int32), [], []
    for _ in range(STEPS):
        tok1, lg, cache = decode(red["jp"], cache, {"tokens": tok})
        tok = tok1[:, None]
        jtoks.append(np.asarray(tok1))
        jlogits.append(np.asarray(lg))
    np.testing.assert_array_equal(toks, np.stack(jtoks, 1))
    np.testing.assert_allclose(logits, np.stack(jlogits, 1), rtol=2e-3, atol=2e-3)


def test_donating_refuses_a_new_value_of_another_shape():
    x = {"x": torch.zeros(3)}
    with pytest.raises(ValueError, match="argument 1 has a leaf"):
        donating(lambda a, c: (a, {"x": c["x"][:1]}), 1)(torch.zeros(2), x)
    with pytest.raises(ValueError, match="step returned"):
        donating(lambda a, c: (a, [c["x"]]), 1)(torch.zeros(2), x)
    assert torch.equal(x["x"], torch.zeros(3))


def test_prefill_step_is_an_int32_scalar_equal_to_t(red):
    for T in (1, 5, 12):
        toks = torch.from_numpy(red["prompts"][:, :T])
        _, cache = R.prefill(red["tcfg"], red["tp"], {"tokens": toks})
        assert cache.step.dtype == torch.int32 and cache.step.dim() == 0
        assert int(cache.step) == T


def test_captured_refuses_cpu_tensors_and_names_the_device():
    cap = captured(lambda x, y: x + y)
    with pytest.raises(ValueError, match="on cpu"):
        cap(torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="no tensor argument"):
        cap(1, 2)
    assert not cap.graphs and not cap.capture_s


def test_captured_train_step_refuses_cpu_tensors_and_names_the_device():
    """The train step's wrapper takes CUDA tensors only (no graph on the
    CPU, and no fallback to the eager step): it raises before it runs or
    adopts anything."""
    ran = []

    def step(params, opt, batch):
        ran.append(1)
        return params, opt, {}

    cap = captured_train_step(step)
    opt = adamw_init({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="on cpu"):
        cap({"w": torch.zeros(3)}, opt, {"tokens": torch.zeros(2, dtype=torch.int32)})
    assert not ran and cap.calls == 0 and cap.donated.params is None


def test_captured_train_step_refuses_a_mesh_whose_collectives_cross_ranks():
    """A sharded step whose mesh has an axis of more than one rank runs
    eager (gloo stages its collectives through the host); one on a mesh of
    one rank an axis is taken."""
    def step(params, opt, batch):
        return params, opt, {}

    step.mesh = types.SimpleNamespace(shape=(2, 1), sizes={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="more than one rank"):
        captured_train_step(step)
    step.mesh = types.SimpleNamespace(shape=(1, 1), sizes={"data": 1, "model": 1})
    assert captured_train_step(step).calls == 0


def test_capture_module_loads_no_jax_and_builds_nothing():
    code = ("import sys; import repro_torch.runtime.capture, "
            "repro_torch.kernels._build as b; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert b._lib is None and b.build_seconds is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
