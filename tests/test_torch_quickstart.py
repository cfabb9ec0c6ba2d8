"""``repro_torch.quickstart`` (the port of ``examples/quickstart.py``) against
the example's loop in the JAX package, on the CPU.

The example's steps as they are written there (``init_params`` at
``PRNGKey(0)``, ``jax.jit`` of the JAX ``build_train_step`` with
``warmup_cosine(2e-3, 10, 120)`` over 8 x 64 tokens of ``data.synthetic``
at seed 0; ``jax.jit`` of ``build_prefill_step(cfg, decode_len=48)`` and of
``build_decode_step`` on ``batch(999)``'s first 2 x 32 tokens) and the
port's ``run`` on the same weights (carried across by ``from_jax_params``):
each step's loss, the prefill's last hidden state and every decode step's
logits on the restored weights within 2e-4 (1 + |b|), the JAX tests'
attention tolerance; a checkpoint restored bit for bit.  Then the module's
own contract: the example's constants, its printed lines, no JAX on
import, and no run on a missing card unless the CPU is asked for.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.models import get_module as j_get_module
from repro.models import params as JP
from repro.optim import adamw_init as j_adamw_init
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime import build_decode_step as j_build_decode_step
from repro.runtime import build_prefill_step as j_build_prefill_step
from repro.runtime import build_train_step as j_build_train_step
from repro_torch import quickstart as qs
from repro_torch.models import get_module
from repro_torch.models.params import from_jax_params, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
STEPS, CKPT_EVERY = 4, 2


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL, err_msg=err_msg)


@pytest.fixture(scope="module")
def jax_loop():
    """The example's steps 1-3 for STEPS steps -> (its initial parameters as
    numpy, each step's loss, its dataset)."""
    jcfg = jreduced(jget("h2o-danube-1.8b"))
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=64, global_batch=8)
    ds = j_make_dataset(jcfg, shape, seed=0)
    params = JP.init_params(jax.random.PRNGKey(0), j_get_module(jcfg).param_defs(jcfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    opt = j_adamw_init(params)
    step_fn = jax.jit(j_build_train_step(jcfg, lr_schedule=j_warmup_cosine(2e-3, 10, 120)))
    losses = []
    for step in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return jcfg, tree, losses, ds


@pytest.fixture(scope="module")
def port_run(jax_loop):
    """The port's ``run`` from the JAX example's weights: STEPS steps, a save
    every CKPT_EVERY, the last one restored, the example's generation."""
    _, tree, _, _ = jax_loop
    cfg = qs.config()
    params = from_jax_params(tree, get_module(cfg).param_defs(cfg), device="cpu")
    lines = []
    res = qs.run(params, steps=STEPS, ckpt_every=CKPT_EVERY, device="cpu",
                 out=lines.append)
    return res, lines


def test_loop_gives_the_jax_examples_losses(jax_loop, port_run):
    """The port's loop on the JAX example's weights gives its per-step
    losses within 2e-4 (the first 3 steps, and the fourth)."""
    _, _, want, _ = jax_loop
    got = port_run[0]["losses"]
    assert len(got) == STEPS
    np.testing.assert_allclose(got[:3], want[:3], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_restored_checkpoint_equals_the_saved_tree_bit_for_bit(port_run):
    """With a save every 2 steps over 4, the last save (step 4, the run's
    final state) reads back bit for bit: parameters, both moments and the
    step count."""
    res = port_run[0]
    assert res["saved_step"] == res["restored_step"] == STEPS
    restored, opt = res["restored"], res["opt"]
    pairs = list(zip(tree_leaves(restored["params"]), tree_leaves(res["params"])))
    pairs += list(zip(tree_leaves(restored["opt"].m), tree_leaves(opt.m)))
    pairs += list(zip(tree_leaves(restored["opt"].v), tree_leaves(opt.v)))
    pairs.append((restored["opt"].count, opt.count))
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b.detach())
    assert int(restored["opt"].count) == STEPS


def test_prefill_and_decode_on_the_restored_weights_match_jax(jax_loop, port_run):
    """JAX's jitted prefill (``decode_len`` 48) and decode steps on the port's
    restored weights and the example's prompt: the last hidden state and
    each of the 16 decode steps' logits within 2e-4 (1 + |b|), and the
    same greedy tokens."""
    jcfg, _, _, ds = jax_loop
    res = port_run[0]
    prompt = ds.batch(999)["tokens"][:2, :32]
    np.testing.assert_array_equal(res["prompt"].numpy(), prompt)
    jparams = jax.tree.map(jnp.asarray, tree_map(
        lambda t, path: t.detach().numpy(), res["restored"]["params"]))
    prefill = jax.jit(j_build_prefill_step(jcfg, decode_len=48))
    decode = jax.jit(j_build_decode_step(jcfg), donate_argnums=(1,))
    last, cache = prefill(jparams, {"tokens": jnp.asarray(prompt)})
    _close(res["last_hidden"].numpy(), last, "last hidden")
    tok = jnp.asarray(prompt[:, -1:])
    toks = []
    for i in range(qs.GEN):
        tok1, logits, cache = decode(jparams, cache, {"tokens": tok})
        _close(res["logits"][i].numpy(), logits, f"decode step {i}")
        tok = tok1[:, None]
        toks.append(np.asarray(tok1))
    np.testing.assert_array_equal(res["generated"].numpy(), np.stack(toks, 1))


def test_the_lines_are_the_examples(jax_loop, port_run):
    """The run prints the example's lines in its order: the arch line, a
    loss every 20 steps, the restore, the generated tokens and the bigram
    count."""
    res, lines = port_run
    assert lines[0] == "arch=h2o-danube-1.8b family=dense params=0.11M (reduced)"
    assert lines[1] == f"step    0 loss={res['losses'][0]:.3f}"
    assert lines[2] == f"restored checkpoint at step {STEPS}"
    assert lines[3] == f"generated: {res['generated'][0].tolist()}"
    assert lines[4] == f"bigram consistency: {res['bigram_hits']}/{qs.GEN - 1}"
    assert len(lines) == 5
    _, _, _, ds = jax_loop
    seq = res["generated"][0].tolist()
    assert res["bigram_hits"] == sum(seq[i + 1] == int(ds.perm[seq[i]])
                                     for i in range(qs.GEN - 1))


def test_the_example_constants_are_the_references():
    """The module's constants are the example's: reduced h2o-danube-1.8b,
    8 rows of 64 tokens at seed 0, ``warmup_cosine(2e-3, 10, 120)``, 120
    steps, a loss line every 20, a save every 60, ``batch(999)``'s first 2 x
    32 tokens, ``decode_len`` 48 and 16 tokens."""
    assert qs.ARCH == "h2o-danube-1.8b" and qs.config().name == "h2o-danube-1.8b"
    assert (qs.SHAPE.seq_len, qs.SHAPE.global_batch, qs.SHAPE.kind) == (64, 8, "train")
    assert (qs.DATA_SEED, qs.PARAM_SEED) == (0, 0)
    assert (qs.LR, qs.WARMUP, qs.DECAY, qs.STEPS) == (2e-3, 10, 120, 120)
    assert (qs.LOG_EVERY, qs.CKPT_EVERY) == (20, 60)
    assert (qs.PROMPT_STEP, qs.PROMPT_ROWS, qs.PROMPT_LEN) == (999, 2, 32)
    assert (qs.DECODE_LEN, qs.GEN) == (48, 16)
    jcfg = jreduced(jget("h2o-danube-1.8b"))
    tcfg = qs.config()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "vocab_size", "window"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_cli_on_the_cpu_saves_restores_and_generates(capsys):
    """``main --device cpu --steps 3``: a save after the third step (the
    cadence cut to the run), the restore at step 3, 16 tokens."""
    res = qs.main(["--device", "cpu", "--steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[2] == "restored checkpoint at step 3"
    assert lines[3].startswith("generated: [") and lines[4].startswith("bigram consistency: ")
    assert res["generated"].shape == (2, 16) and np.isfinite(res["losses"]).all()


def test_module_loads_no_jax():
    code = ("import sys; import repro_torch.quickstart; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        qs.main(["--steps", "1"])
