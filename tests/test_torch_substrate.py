"""The port's training substrate against the JAX package's, on the CPU.

Ports of ``tests/test_substrate.py``'s checkpoint, data, optimizer,
clipping, schedule, compression and watchdog tests (its PartitionSpec,
roofline and collective-parser tests belong to the distributed runtime
and the dry-run, ROADMAP queue 1 items 8 and 9), and equality with the
reference on the same numpy inputs: the synthetic batches bit for bit,
AdamW, clipping and the schedule within 3e-5 (1 + |b|) (float32 sums and
transcendentals in another order), the quantizer exactly, and checkpoints
written by either package read by the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import optim as joptim
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.data import synthetic as jdata
from repro.launch.specs import input_specs as j_input_specs
from repro.optim import compression as jcomp
from repro.runtime.watchdog import StragglerWatchdog as JWatchdog
from repro_torch import configs as TC
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, restore, save_checkpoint)
from repro_torch.data.synthetic import (SyntheticLMDataset,
                                        SyntheticSeq2SeqDataset, make_dataset)
from repro_torch.launch.specs import input_specs
from repro_torch.models.params import tree_leaves
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, constant_schedule,
                               global_norm, warmup_cosine)
from repro_torch.optim.compression import (dequantize_int8, init_feedback,
                                           quantize_int8,
                                           quantize_with_feedback)
from repro_torch.runtime.watchdog import StragglerWatchdog

TOL = 3e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _np_tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((4, 8)).astype(np.float32),
            "nested": {"b": r.standard_normal(3).astype(np.float32),
                       "c": [np.ones((2, 2), np.float32),
                             np.zeros(5, np.float32)]},
            "count": np.asarray(7, np.int32)}


def _torch_tree(seed=0):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x))
    return conv(_np_tree(seed))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = _torch_tree()
    save_checkpoint(tmp_path, 3, tree)
    step, restored = load_checkpoint(tmp_path, like=tree)
    assert step == 3
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b)
    step, placed = restore(tmp_path, tree, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(placed)):
        assert b.dtype == a.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    tree = _torch_tree()
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000003", "step_00000004"]


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir must never shadow a committed checkpoint."""
    tree = _torch_tree()
    save_checkpoint(tmp_path, 1, tree)
    (tmp_path / "step_00000002.tmp").mkdir()      # simulated crash
    assert latest_step(tmp_path) == 1
    step, _ = load_checkpoint(tmp_path, like=tree)
    assert step == 1


def test_async_checkpoint_snapshots_before_an_in_place_update(tmp_path):
    """``save`` copies each leaf before it returns: the train step updates
    its tensors in place right after."""
    tree = _torch_tree()
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, tree)
    tree["a"].add_(1.0)
    ck.wait()
    _, restored = load_checkpoint(tmp_path, like=tree)
    np.testing.assert_array_equal(restored["a"], _np_tree()["a"])


def _opt_trees(seed):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((6, 5)).astype(np.float32),
              "blocks": {"s": r.standard_normal((2, 5)).astype(np.float32)},
              "b": r.standard_normal(5).astype(np.float32)}
    return params


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_is_read_by_the_other_package(tmp_path, writer):
    """One on-disk layout: {"params", "opt": AdamWState} written by either
    package restores in the other, every leaf bit for bit."""
    p_np = _opt_trees(1)
    m_np = jax.tree.map(lambda a: a * 0.5, p_np)
    jp = jax.tree.map(jnp.asarray, p_np)
    jopt = joptim.AdamWState(count=jnp.asarray(5, jnp.int32),
                             m=jax.tree.map(jnp.asarray, m_np),
                             v=jax.tree.map(jnp.zeros_like, jp))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p_np)
    topt = AdamWState(count=torch.tensor(5, dtype=torch.int32),
                      m=jax.tree.map(lambda a: torch.from_numpy(np.array(a)), m_np),
                      v=jax.tree.map(lambda a: torch.zeros(a.shape), p_np))
    if writer == "jax":
        jck.save_checkpoint(tmp_path, 5, {"params": jp, "opt": jopt})
        fresh = {"params": jax.tree.map(torch.zeros_like, tp),
                 "opt": adamw_init(jax.tree.map(torch.zeros_like, tp))}
        step, got = restore(tmp_path, fresh, device="cpu")
        got_leaves = [t.numpy() for t in tree_leaves(got["params"])] + [
            got["opt"].count.numpy()] + [
            t.numpy() for t in tree_leaves(got["opt"].m) + tree_leaves(got["opt"].v)]
    else:
        save_checkpoint(tmp_path, 5, {"params": tp, "opt": topt})
        step, got = jck.load_checkpoint(tmp_path, like={"params": jp, "opt": jopt})
        got_leaves = [np.asarray(a) for a in
                      jax.tree.leaves(got["params"]) + [got["opt"].count]
                      + jax.tree.leaves(got["opt"].m) + jax.tree.leaves(got["opt"].v)]
    want = ([np.asarray(a) for a in jax.tree.leaves(jp)] + [np.asarray(5, np.int32)]
            + [np.asarray(a) for a in jax.tree.leaves(jopt.m) + jax.tree.leaves(jopt.v)])
    assert step == 5 and len(got_leaves) == len(want) == 10
    for a, b in zip(got_leaves, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_deterministic_resume():
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4)
    b1 = ds.batch(10)
    ds2 = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4)
    b2 = ds2.batch(10)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_data_labels_are_next_tokens():
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4,
                            noise=0.0)
    b = ds.batch(0)
    # bigram language: label = perm[token] everywhere when noise=0
    np.testing.assert_array_equal(b["labels"], ds.perm[b["tokens"]])


def test_data_process_sharding_differs():
    kw = dict(vocab_size=128, seq_len=16, global_batch=8, process_count=2)
    d0 = SyntheticLMDataset(process_index=0, **kw)
    d1 = SyntheticLMDataset(process_index=1, **kw)
    assert d0.local_batch == 4
    assert not np.array_equal(d0.batch(0)["tokens"], d1.batch(0)["tokens"])


def test_data_steps_differ():
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4)
    assert not np.array_equal(ds.batch(0)["tokens"], ds.batch(1)["tokens"])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "seamless-m4t-large-v2",
                                  "qwen2-vl-2b"])
def test_data_batches_equal_the_reference_bit_for_bit(arch):
    """``make_dataset`` of either package: the same batches, bit for bit
    (language and seq2seq, M-RoPE positions, two processes)."""
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=24,
                                global_batch=4)
    jcfg = jget(arch)
    tcfg = TC.get_config(arch)
    for pi in (0, 1):
        a = jdata.make_dataset(jcfg, shape, seed=3, process_index=pi,
                               process_count=2)
        b = make_dataset(tcfg, TC.ShapeConfig(shape.name, shape.kind,
                                              shape.seq_len, shape.global_batch),
                         seed=3, process_index=pi, process_count=2)
        assert type(b).__name__ == type(a).__name__
        for step in (0, 7):
            ba, bb = a.batch(step), b.batch(step)
            assert sorted(ba) == sorted(bb)
            for key in ba:
                assert ba[key].dtype == bb[key].dtype
                np.testing.assert_array_equal(ba[key], bb[key])
    assert isinstance(make_dataset(TC.get_config("olmo-1b"), TC.ShapeConfig(
        "t", "train", 8, 2)), SyntheticLMDataset)
    assert SyntheticSeq2SeqDataset.__module__ == "repro_torch.data.synthetic"


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_descends_quadratic():
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal(8).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = adamw_init(params)
    for _ in range(200):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state = adamw_update(g, state, params, lr=0.05,
                                     weight_decay=0.0)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.from_numpy(np.random.default_rng(1).standard_normal(32)
                               .astype(np.float32)) * 100}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert float(global_norm(clipped)) <= 1.0 + 1e-5


def test_warmup_cosine_shape():
    fn = warmup_cosine(1e-3, 10, 100)
    lrs = [float(fn(s)) for s in range(100)]
    assert lrs[0] > 0                       # no wasted step-0
    assert abs(max(lrs) - 1e-3) < 1e-9
    assert np.argmax(lrs) == 9              # peak at end of warmup
    assert lrs[-1] < 0.2 * 1e-3             # decayed


def test_schedules_equal_the_reference():
    """``warmup_cosine`` and ``constant_schedule`` at every step of a run,
    from an int and from the optimizer's int32 count, in float32."""
    for args in ((3e-4, 5, 20), (1e-3, 10, 100), (2e-3, 0, 7)):
        jfn, tfn = joptim.warmup_cosine(*args), warmup_cosine(*args)
        for s in range(args[2] + 3):
            got = tfn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, jfn(jnp.asarray(s, jnp.int32)))
            _close(tfn(s), jfn(s))
    assert float(constant_schedule(5e-4)(3)) == float(
        joptim.constant_schedule(5e-4)(3))


def test_adamw_and_clip_equal_the_reference_over_steps():
    """Three steps of clip_by_global_norm + adamw_update on one tree from
    the same numpy gradients, at the schedule's rate: parameters, moments,
    norms and the count within 3e-5 (1 + |b|)."""
    p_np = _opt_trees(2)
    r = np.random.default_rng(3)
    grads = [{k: (r.standard_normal(np.shape(v)) * 3).astype(np.float32)
              if not isinstance(v, dict) else
              {kk: (r.standard_normal(np.shape(vv)) * 3).astype(np.float32)
               for kk, vv in v.items()} for k, v in p_np.items()}
             for _ in range(3)]
    sched_j, sched_t = joptim.warmup_cosine(1e-2, 2, 5), warmup_cosine(1e-2, 2, 5)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = joptim.adamw_init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p_np)
    tst = adamw_init(tp)
    for g in grads:
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        jp, jst = joptim.adamw_update(jg, jst, jp, lr=sched_j(jst.count))
        tg, tn = clip_by_global_norm(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), g), 1.0)
        tp, tst = adamw_update(tg, tst, tp, lr=sched_t(tst.count))
        _close(tn, jn)
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            _close(a, b)
    assert int(tst.count) == int(jst.count) == 3
    for t_tree, j_tree in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for a, b in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
            _close(a, b)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(1024)
                         .astype(np.float32)) * 3
    q, scale = quantize_int8(x)
    err = torch.abs(dequantize_int8(q, scale) - x)
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_unbiased():
    """With feedback, the accumulated dequantized sum tracks the true sum
    (compression error does not accumulate)."""
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal((50, 256))
                          .astype(np.float32))
    residual = init_feedback({"g": xs[0]})["g"]
    acc = torch.zeros(256)
    for i in range(50):
        q, scale, residual = quantize_with_feedback(xs[i], residual)
        acc = acc + dequantize_int8(q, scale)
    true = xs.sum(0)
    np.testing.assert_allclose((acc + residual).numpy(), true.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(torch.abs(acc - true).max()) < 0.2


def test_quantizer_equals_the_reference():
    """The int8 codes and scales of either package, bit for bit, with and
    without feedback, and on an all-zero tensor (scale 1)."""
    r = np.random.default_rng(6)
    x, res = (r.standard_normal(300).astype(np.float32) * 5 for _ in range(2))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jq, js, jr = jcomp.quantize_with_feedback(jnp.asarray(x), jnp.asarray(res))
    tq, ts, tr = quantize_with_feedback(torch.from_numpy(x), torch.from_numpy(res))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    zq, zs = quantize_int8(torch.zeros(4))
    assert float(zs) == 1.0 and not zq.any()


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


def test_watchdog_flags_outliers():
    events = []
    wd = StragglerWatchdog(threshold=2.0, patience=2, warmup_steps=0,
                           on_escalate=events.append)
    wd.record(0, 1.0)
    for s in range(1, 5):
        assert not wd.record(s, 1.0)
    assert wd.record(5, 5.0)
    assert wd.record(6, 5.0)
    assert events                       # escalated after patience=2


def test_watchdog_ignores_warmup():
    wd = StragglerWatchdog(warmup_steps=2, threshold=2.0)
    assert not wd.record(0, 100.0)      # compile step
    assert not wd.record(1, 100.0)


def test_watchdog_equals_the_reference():
    """One sequence of step times: the same outliers, EMA and escalations."""
    times = [1.0, 1.2, 0.9, 5.0, 4.0, 6.0, 1.0, 1.1, 9.0, 8.0, 7.5, 1.0]
    ja, ta = [], []
    jw = JWatchdog(threshold=2.0, patience=2, warmup_steps=1, on_escalate=ja.append)
    tw = StragglerWatchdog(threshold=2.0, patience=2, warmup_steps=1,
                           on_escalate=ta.append)
    flags = [(jw.record(s, t), tw.record(s, t)) for s, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert ja == ta and jw.outliers == tw.outliers and jw.ema == tw.ema


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_train_input_specs_equal_the_reference(arch):
    """``input_specs`` of a train cell: the keys, shapes and dtypes of the
    reference's ShapeDtypeStructs."""
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=32,
                                global_batch=2)
    want = j_input_specs(jget(arch), shape)
    got = input_specs(TC.get_config(arch), TC.ShapeConfig(
        shape.name, shape.kind, shape.seq_len, shape.global_batch))
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert got[key].shape == tuple(spec.shape)
        assert got[key].dtype == getattr(torch, str(spec.dtype))
