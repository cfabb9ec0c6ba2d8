"""The port's Qwen2-VL backbone against the JAX package with three M-RoPE
position streams that differ, on the CPU.

``tests/test_torch_transformer.py`` builds no ``positions``, so there every
stream is ``arange(S)`` and M-RoPE is RoPE.  Here the prompt opens with an
image of 4 x 4 patches (t = 0, h = i // 4, w = i % 4) and the text after it
runs from 4 on all three axes, as Qwen2-VL numbers them: the reduced
``qwen2-vl-2b`` (2 layers, d 64, 4 heads of 16 over 2 KV heads, M-RoPE
sections 2 / 3 / 3) prefills ``inputs_embeds`` [B, S, 64] with those
positions, then takes 4 decode steps at the reference's step position.
Weights from ``repro.models.params.init_params`` carried across as numpy;
tolerance 2e-4, the attention tolerance of the JAX tests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import params as JP
from repro.models import transformer as J
from repro_torch import configs as TC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = 2e-4
ARCH = "qwen2-vl-2b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _setup(B=2, S=40, side=4, seed=11):
    jcfg, tcfg = jreduced(jget(ARCH)), TC.reduced(TC.get_config(ARCH))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        lambda key: JP.init_params(key, J.param_defs(jcfg)))(jax.random.PRNGKey(1)))
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32),
             "inputs_embeds": r.standard_normal((B, S, tcfg.d_model)).astype(np.float32),
             "positions": L.image_text_positions(B, S, side).numpy()}
    return jcfg, tcfg, tree, batch


def test_the_positions_are_three_distinct_streams():
    pos = L.image_text_positions(1, 40, 4).numpy()[:, 0]
    assert pos[:, :16].tolist() == [[0] * 16, [i // 4 for i in range(16)],
                                    [i % 4 for i in range(16)]]
    assert (pos[:, 16:] == np.arange(4, 28)).all()
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()


def test_prefill_with_image_positions_then_decode_matches_jax():
    jcfg, tcfg, tree, batch = _setup()
    jp = jax.tree.map(jnp.asarray, tree)
    tp = T.load_params(tcfg, tree, device="cpu")
    jlast, jc = jax.jit(functools.partial(J.prefill, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlast, tc = T.prefill(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tlast, jlast)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    jdecode = jax.jit(functools.partial(J.decode_step, jcfg))
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 4), dtype=np.int32)
    for i in range(4):
        jl, jc = jdecode(jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tl, tc = T.decode_step(tcfg, tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1])})
        _close(tl, jl)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert int(tc.step) == int(jc.step) == 40 + i + 1


def test_the_streams_move_the_result():
    """The same prompt with ``arange`` on all three streams (M-RoPE as RoPE)
    gives another last hidden state and other keys: the check above
    exercises the sections."""
    _, tcfg, tree, batch = _setup()
    tp = T.load_params(tcfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    last, cache = T.prefill(tcfg, tp, tb)
    plain_last, plain_cache = T.prefill(
        tcfg, tp, {k: v for k, v in tb.items() if k != "positions"})
    assert (last - plain_last).abs().max() > 1e-2
    assert (cache.k - plain_cache.k).abs().max() > 1e-2
