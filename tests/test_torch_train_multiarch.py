"""``repro_torch.train_multiarch`` (the port of ``examples/train_multiarch.py``)
against the example's loop in the JAX package, on the CPU.

The example's inner loop as it is written there (``jax.jit`` of the JAX
``build_train_step`` with ``warmup_cosine(1e-3, 5, 30)``, 4 x 48 tokens of
``data.synthetic`` at seed 1, ``init_params`` at ``PRNGKey(0)``) and the
port's ``train_arch`` on the same weights (carried across by
``from_jax_params``): each step's loss within 2e-4 (1 + |b|), the JAX
tests' attention tolerance, over 3 steps at ``reduced`` size.  Then the
module's own contract: no JAX on import, and no run on a missing card
unless the CPU is asked for.
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
from repro.runtime import build_train_step as j_build_train_step
from repro_torch import configs as TC
from repro_torch import train_multiarch as tm
from repro_torch.models import get_module
from repro_torch.models.params import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
STEPS = 3


def _jax_example_losses(jcfg, steps):
    """``examples/train_multiarch.py``'s loop for one arch, ``steps`` steps
    -> (its initial parameters as numpy, each step's loss)."""
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=48,
                                global_batch=4)
    ds = j_make_dataset(jcfg, shape, seed=1)
    params = JP.init_params(jax.random.PRNGKey(0), j_get_module(jcfg).param_defs(jcfg))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    opt = j_adamw_init(params)
    step_fn = jax.jit(j_build_train_step(jcfg, lr_schedule=j_warmup_cosine(1e-3, 5, 30)))
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return tree, losses


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_loop_gives_the_jax_examples_losses(arch):
    """The port's loop on the JAX example's weights gives its per-step
    losses within 2e-4 over 3 steps."""
    jcfg, tcfg = jreduced(jget(arch)), TC.reduced(TC.get_config(arch))
    tree, want = _jax_example_losses(jcfg, STEPS)
    params = from_jax_params(tree, get_module(tcfg).param_defs(tcfg), device="cpu")
    got = tm.train_arch(tcfg, params, steps=STEPS, device="cpu")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_example_shape_and_schedule_are_the_references():
    """The module's constants are the example's: 4 rows of 48 tokens,
    ``warmup_cosine(1e-3, 5, 30)``, 12 steps, every arch of ``ARCHS``."""
    assert (tm.SHAPE.seq_len, tm.SHAPE.global_batch, tm.SHAPE.kind) == (48, 4, "train")
    assert (tm.LR, tm.WARMUP, tm.DECAY, tm.STEPS) == (1e-3, 5, 30, 12)
    assert (tm.DATA_SEED, tm.PARAM_SEED) == (1, 0)
    from repro.configs import ARCHS as JARCHS
    assert sorted(TC.ARCHS) == sorted(JARCHS)


def test_cli_on_the_cpu_prints_a_line_an_arch_and_the_loss_falls(capsys):
    """``main --device cpu`` over two archs: a line each in the example's
    form, finite losses, the last below the first."""
    out = tm.main(["--device", "cpu", "--arch", "olmo-1b", "rwkv6-1.6b",
                   "--steps", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["olmo-1b", "rwkv6-1.6b"]
    assert "[dense ] loss" in lines[0] and "[ssm   ] loss" in lines[1]
    for losses in out.values():
        assert len(losses) == 6 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]


def test_module_loads_no_jax():
    code = ("import sys; import repro_torch.train_multiarch; "
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
        tm.main(["--arch", "olmo-1b", "--steps", "1"])
