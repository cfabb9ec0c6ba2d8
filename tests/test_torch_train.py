"""The port's training path against the JAX package's, on the CPU.

``runtime.build_train_step`` of either package from the same parameters
(the JAX package's ``init_params`` carried across by ``from_jax_params``)
and the same synthetic batches, three steps at ``reduced`` size (float32):
loss, gradient norm, rate, every parameter and both moments within 2e-4
(1 + |b|), the attention tolerance of the JAX tests (float32 sums in
another order through two layers and three AdamW steps; the port's
attention backward is ``ref.attention_bwd_ref`` here, the JAX one its
blocked ``_flash_bwd``).  Then the ports of ``tests/test_system.py``'s
training tests: resume bit for bit, the loss falling on the synthetic
language, and the launcher end to end (under ``slow``, as there).
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
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data.synthetic import make_dataset
from repro_torch.launch import train as ttrain
from repro_torch.models import get_module
from repro_torch.models.params import (from_jax_params, init_params,
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.runtime import build_grad_fn, build_train_step

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
# the costliest reduced configs, under ``slow`` as in tests/test_arch_smoke.py
_HEAVY = {"recurrentgemma-2b", "seamless-m4t-large-v2", "rwkv6-1.6b",
          "h2o-danube-1.8b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"}
_OTHERS = {"minitron-4b", "starcoder2-15b", "qwen2-vl-2b"}
STEP_ARCHS = ["olmo-1b"] + [pytest.param(a, marks=pytest.mark.slow)
                            for a in sorted(_HEAVY | _OTHERS)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _shape(seq, batch):
    return TC.ShapeConfig("train_4k", "train", seq, batch)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _steps_match(arch, steps, seq, batch=2):
    """``steps`` train steps of either package from the same parameters and
    batches of ``batch`` x ``seq`` tokens: the metrics of each step, then
    every parameter and both moments, within 2e-4 (1 + |b|)."""
    jcfg = jreduced(jget(arch))
    tcfg = TC.reduced(TC.get_config(arch))
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=seq,
                                global_batch=batch)
    jds = j_make_dataset(jcfg, shape, seed=11)
    tds = make_dataset(tcfg, _shape(seq, batch), seed=11)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        lambda key: JP.init_params(key, j_get_module(jcfg).param_defs(jcfg)))(
            jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = j_adamw_init(jp)
    jstep = jax.jit(j_build_train_step(
        jcfg, lr_schedule=j_warmup_cosine(1e-3, 2, 10)))
    tp = from_jax_params(tree, get_module(tcfg).param_defs(tcfg), device="cpu")
    topt = adamw_init(tp)
    tstep = build_train_step(tcfg, lr_schedule=warmup_cosine(1e-3, 2, 10))
    for s in range(steps):
        nb = jds.batch(s)
        for key in nb:
            np.testing.assert_array_equal(nb[key], tds.batch(s)[key])
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in nb.items()})
        tp, topt, tm = tstep(tp, topt, _to_torch(nb))
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            _close(tm[key], jm[key])
    assert int(topt.count) == int(jopt.count) == steps

    def part(k):      # a dict key, a NamedTuple field or a list index
        return str(next(getattr(k, a) for a in ("key", "name", "idx")
                        if hasattr(k, a)))

    flat_j = {"/".join(part(k) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  {"p": jp, "m": jopt.m, "v": jopt.v})[0]}
    flat_t = {}
    for name, t_tree in (("p", tp), ("m", topt.m), ("v", topt.v)):
        tree_map(lambda leaf, path: flat_t.__setitem__(
            f"{name}/" + path.replace(".", "/"), leaf), t_tree)
    assert sorted(flat_t) == sorted(flat_j)
    for key, leaf in flat_t.items():
        _close(leaf.numpy(), flat_j[key])


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_the_reference(arch):
    """Three train steps of either package from the same parameters and
    batches (2 x 32 tokens): the metrics of each step, then every parameter
    and both moments, within 2e-4 (1 + |b|)."""
    _steps_match(arch, 3, 32)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b"])
def test_one_step_of_each_family_trained_on_the_card_matches_the_reference(arch):
    """The three families that ``chip_smoke.py`` phase 5l trains on the
    card, at ``reduced`` size: Seamless at 2 + 2 layers, RecurrentGemma at
    3 (recurrent, recurrent, attention), qwen2-moe at 2; one step of 2 x 16
    tokens of either package: loss, gradient norm, every parameter and both
    moments within 2e-4 (1 + |b|)."""
    _steps_match(arch, 1, 16)


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-large-v2",
                                  "recurrentgemma-2b", "rwkv6-1.6b"])
def test_remat_changes_no_number(arch):
    """The gradients with and without ``remat`` (each block under
    ``torch.utils.checkpoint``), bit for bit, for each model family."""
    cfg = TC.reduced(TC.get_config(arch))
    mod = get_module(cfg)
    params = from_jax_params(init_params(1, mod.param_defs(cfg)), device="cpu")
    batch = _to_torch(make_dataset(cfg, _shape(24, 2), seed=2).batch(0))
    with_remat = build_grad_fn(cfg, remat=True)(params, batch)
    without = build_grad_fn(cfg, remat=False)(params, batch)
    assert torch.equal(with_remat[0], without[0])
    for a, b in zip(tree_leaves(with_remat[2]), tree_leaves(without[2])):
        assert torch.equal(a, b)


def _fresh(cfg, seed=0):
    mod = get_module(cfg)
    params = tree_map(lambda a, path: torch.from_numpy(a).requires_grad_(),
                      init_params(seed, mod.param_defs(cfg)))
    return params, adamw_init(params)


def _run_steps(params, opt, ds, step_fn, start, end):
    metrics = None
    for s in range(start, end):
        params, opt, metrics = step_fn(params, opt, _to_torch(ds.batch(s)))
    return params, opt, metrics


def test_resume_bitexact(tmp_path):
    """Port of test_system.py::test_resume_bitexact: 6 steps straight
    against 3 + checkpoint + restore into fresh tensors + 3: identical."""
    cfg = TC.reduced(TC.get_config("olmo-1b"))
    ds = make_dataset(cfg, _shape(32, 4), seed=11)
    step_fn = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10))

    # straight run
    p_a, o_a, _ = _run_steps(*_fresh(cfg), ds, step_fn, 0, 6)

    # interrupted run (the step updates in place: a run of its own tensors)
    p_b, o_b, _ = _run_steps(*_fresh(cfg), ds, step_fn, 0, 3)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, {"params": p_b, "opt": o_b})
    ck.wait()
    p_new, o_new = _fresh(cfg, seed=99)
    step, restored = restore(tmp_path, {"params": p_new, "opt": o_new}, device="cpu")
    assert step == 3
    assert all(t.requires_grad for t in tree_leaves(restored["params"]))
    p_c, o_c, _ = _run_steps(restored["params"], restored["opt"], ds,
                             step_fn, 3, 6)

    for a, b in zip(tree_leaves(p_a), tree_leaves(p_c)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(o_a.m) + tree_leaves(o_a.v),
                    tree_leaves(o_c.m) + tree_leaves(o_c.v)):
        assert torch.equal(a, b)
    assert int(o_a.count) == int(o_c.count) == 6


def test_loss_decreases_on_synthetic_language():
    """Port of test_system.py::test_loss_decreases_on_synthetic_language:
    60 steps cut the loss to under half its first value."""
    cfg = TC.reduced(TC.get_config("h2o-danube-1.8b"))
    ds = make_dataset(cfg, _shape(64, 8), seed=5)
    step_fn = build_train_step(cfg, lr_schedule=warmup_cosine(2e-3, 10, 60))
    params, opt = _fresh(cfg)
    losses = []
    for s in range(60):
        params, opt, metrics = step_fn(params, opt, _to_torch(ds.batch(s)))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5]), (
        losses[:5], losses[-10:])


_CLI = ["--arch", "olmo-1b", "--reduced", "--steps", "8", "--batch", "2",
        "--seq", "32", "--ckpt-every", "4", "--log-every", "4",
        "--device", "cpu"]


def test_train_cli_resumes_in_process(tmp_path, capsys):
    """``launch.train.main``: 8 steps with checkpoints at 4 and 8, then a
    run to 12 that resumes from step 8 with the log lines of the
    reference's launcher."""
    ttrain.main(_CLI + ["--ckpt-dir", str(tmp_path)])
    first = capsys.readouterr().out
    assert latest_step(tmp_path) == 8
    assert first.splitlines()[0].startswith("arch=olmo-1b params=")
    assert "step     0 loss=" in first and first.rstrip().endswith("done")
    argv = _CLI + ["--ckpt-dir", str(tmp_path)]
    argv[argv.index("--steps") + 1] = "12"
    ttrain.main(argv)
    second = capsys.readouterr().out
    assert "resumed from step 8" in second and "step     8 loss=" in second
    assert latest_step(tmp_path) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000008", "step_00000012"]


@pytest.mark.slow
def test_train_cli_end_to_end(tmp_path):
    """Port of test_system.py::test_train_cli_end_to_end: the launcher as a
    process, train, then resume."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *_CLI,
           "--ckpt-dir", str(tmp_path)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r1 = subprocess.run(cmd, capture_output=True, text=True, env=env,
                        cwd=ROOT, timeout=600)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert latest_step(tmp_path) == 8
    cmd[cmd.index("--steps") + 1] = "12"
    r2 = subprocess.run(cmd, capture_output=True, text=True, env=env,
                        cwd=ROOT, timeout=600)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 8" in r2.stdout
    assert latest_step(tmp_path) == 12


def test_train_cli_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--arch", "olmo-1b", "--reduced", "--steps", "1"])


def test_train_step_on_a_stacked_tree_casts_before_the_layers():
    """Under a bf16 compute dtype the step casts every float32 leaf of at
    least two dimensions of the stacked tree (norm scales [L, D] included),
    as the reference's ``_cast``; the gradients come back float32."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("h2o-danube-1.8b")),
                              dtype="bfloat16")
    mod = get_module(cfg)
    params = from_jax_params(init_params(0, mod.param_defs(cfg)), device="cpu")
    seen = []
    orig = mod.forward

    def spy(cfg_, p, batch, **kw):
        seen.append((p["blocks"]["ln1"]["scale"].dtype, p["ln_f"]["scale"].dtype,
                     p["embed"]["embedding"].dtype))
        return orig(cfg_, p, batch, **kw)

    mod.forward = spy
    try:
        loss, _, grads = build_grad_fn(cfg)(
            params, _to_torch(make_dataset(cfg, _shape(16, 2), seed=0).batch(0)))
    finally:
        mod.forward = orig
    assert seen == [(torch.bfloat16, torch.float32, torch.bfloat16)]
    assert torch.isfinite(loss)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
