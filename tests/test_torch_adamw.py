"""The port's AdamW entry point and its donated train step, on the CPU.

``kernels.ops.adamw_update`` is one leaf's update in place, the clip's
factor folded in.  On a CPU tensor it runs its plain version
(``kernels.ref.adamw_ref``), held here to the reference's
``repro.optim.adamw_update`` on the same numpy leaves (3 steps at
``warmup_cosine``'s rate, with and without a clip factor below 1; within
3e-5 (1 + |b|), float32 rounded at other places by XLA) and to the port's
tree composition before the kernel (the clip's in-place scale, then the
update in 16 PyTorch operations a leaf: ``torch.equal``).  On a ``meta``
tensor it launches nothing and counts its formula; under ``ref.PLAIN`` no
kernel is counted at all.  ``runtime.capture.donated_train_step`` is the
part of ``captured_train_step`` that is no graph: the donated trees and the
count written back, held to the reference's ``jax.jit(build_train_step(...),
donate_argnums=(0, 1))`` over 3 steps of reduced olmo-1b (within 2e-4, the
tolerance of ``test_torch_train.py``).  The kernel itself runs on the card
only: ``tests/test_torch_cuda.py -k adamw``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.models import get_module as j_get_module
from repro.models import params as JP
from repro.runtime import build_train_step as j_build_train_step
from repro_torch import configs as TC
from repro_torch.core import opcount
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import ops, ref
from repro_torch.models import get_module
from repro_torch.models.params import from_jax_params, tree_leaves, tree_map
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                               clip_scale, global_norm, warmup_cosine)
from repro_torch.runtime import build_train_step, donated_train_step

SHAPES = {"w": (7, 5), "b": (5,), "blocks": {"k": (3, 4, 6), "s": (11,)}}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (r.standard_normal(s) * scale).astype(np.float32)
    return draw(SHAPES)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("max_norm", [None, 0.5], ids=["no_clip", "clip"])
def test_plain_leaf_update_equals_the_reference_over_steps(max_norm):
    """``ops.adamw_update`` leaf by leaf on CPU tensors against
    ``repro.optim.adamw_update`` (after ``repro.optim.clip_by_global_norm``
    where there is a clip), three steps at the schedule's rate."""
    grads = [_tree(10 + s, 3.0) for s in range(3)]
    sched_j, sched_t = joptim.warmup_cosine(1e-2, 2, 5), warmup_cosine(1e-2, 2, 5)
    jp = jax.tree.map(jnp.asarray, _tree(1))
    jst = joptim.adamw_init(jp)
    tp = _torch(_tree(1))
    tm, tv = jax.tree.map(torch.zeros_like, tp), jax.tree.map(torch.zeros_like, tp)
    for step, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, g)
        tg = _torch(g)
        scale = None
        if max_norm is not None:
            jg, _ = joptim.clip_by_global_norm(jg, max_norm)
            scale = clip_scale(global_norm(tg), max_norm)
            assert float(scale) < 1.0
        jp, jst = joptim.adamw_update(jg, jst, jp, lr=sched_j(jst.count))
        c = torch.tensor(step + 1, dtype=torch.float32)
        lr = sched_t(torch.tensor(step, dtype=torch.int32))
        bc1, bc2 = 1.0 - torch.pow(0.9, c), 1.0 - torch.pow(0.95, c)
        for p, gl, m, v in zip(tree_leaves(tp), tree_leaves(tg), tree_leaves(tm),
                               tree_leaves(tv)):
            before = gl.clone()
            assert ops.adamw_update(p, gl, m, v, lr=lr, bc1=bc1, bc2=bc2, scale=scale) is None
            assert torch.equal(gl, before)            # the gradient is read only
    for t_tree, j_tree in ((tp, jp), (tm, jst.m), (tv, jst.v)):
        for a, b in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
            _close(a, b, 3e-5)


def _previous_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1):
    """The port's ``optim.adamw_update`` before the kernel: 16 PyTorch
    operations a leaf."""
    with torch.no_grad():
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.float()
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1.0 - b2))
            vhat = v / bc2
            step = (m / bc1).div_(vhat.sqrt_().add_(eps)).add_(weight_decay * p)
            p.sub_(step.mul_(lr).to(p.dtype))
        return params, AdamWState(count=count, m=state.m, v=state.v)


@pytest.mark.parametrize("kernels", [ops, ref.PLAIN], ids=["ops", "plain"])
@pytest.mark.parametrize("max_norm", [None, 0.5, 1e3], ids=["no_clip", "clip", "no_cut"])
def test_update_is_the_previous_composition_bit_for_bit(max_norm, kernels):
    """The tree update with the clip's factor folded in, against the
    previous composition (``clip_by_global_norm`` scaling the gradients in
    place, then the 16-operation update): the same bits, 4 steps."""
    sched = warmup_cosine(3e-3, 2, 6)
    new_p, old_p = _torch(_tree(2)), _torch(_tree(2))
    new_s, old_s = adamw_init(new_p), adamw_init(old_p)
    for step in range(4):
        g = _tree(20 + step, 2.0)
        new_g, old_g = _torch(g), _torch(g)
        scale = None
        if max_norm is not None:
            scale = clip_scale(global_norm(new_g), max_norm)
            old_g, _ = clip_by_global_norm(old_g, max_norm)
        new_p, new_s = adamw_update(new_g, new_s, new_p, lr=sched(new_s.count),
                                    scale=scale, kernels=kernels)
        old_p, old_s = _previous_update(old_g, old_s, old_p, lr=sched(old_s.count))
        assert torch.equal(new_g["w"], torch.from_numpy(g["w"]))   # not scaled in place
    for a, b in zip(tree_leaves((new_p, new_s)), tree_leaves((old_p, old_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(new_s.count) == 4


def test_meta_route_launches_nothing_and_counts_the_formula():
    p, g, m, v = (torch.empty(3, 1000, device="meta") for _ in range(4))
    lr, bc1, bc2, scale = (torch.empty((), device="meta") for _ in range(4))
    before = kadamw.launches
    with opcount.OpCounter() as c:
        c.hold(p, g, m, v)
        out = ops.adamw_update(p, g, m, v, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    assert out is None and kadamw.launches == before
    assert dict(c.by_name) == {"adamw": {"calls": 1, "flops": 0,
                                         "bytes accessed": 28 * 3000 + 16,
                                         "transcendentals": 3000}}
    assert c.read(m) and c.read(v) and c.read(lr) and c.read(scale)
    assert opcount.adamw_counts(p, g, m, v, lr, bc1, bc2, None) == dict(
        flops=0, bytes_accessed=28 * 3000 + 12, transcendentals=3000)


def test_kernel_wrapper_refuses_host_tensors_before_it_builds():
    """The wrapper itself takes CUDA tensors only: given CPU ones (which
    ``ops`` would route to the plain version) it raises, naming the
    device, before anything is built or launched."""
    from repro_torch.kernels import _build
    p, g, m, v = (torch.zeros(5) for _ in range(4))
    lr, bc1, bc2 = (torch.ones(()) for _ in range(3))
    before, lib = kadamw.launches, _build._lib
    with pytest.raises(ValueError, match="p is on cpu"):
        kadamw.adamw_update(p, g, m, v, lr=lr, bc1=bc1, bc2=bc2, scale=None, b1=0.9,
                            b2=0.95, eps=1e-8, weight_decay=0.1)
    assert kadamw.launches == before and _build._lib is lib


def test_plain_namespace_counts_no_kernel_and_ops_one_a_leaf():
    """A tree update under ``ref.PLAIN`` is aten operations only (the
    dry-run counts them one by one); through ``ops`` on the CPU each leaf
    is one ``adamw`` entry by formula, and nothing launches."""
    leaves = len(tree_leaves(_tree(0)))
    n = sum(a.size for a in tree_leaves(_tree(0)))
    for kernels in (ref.PLAIN, ops):
        params = _torch(_tree(3))
        state = adamw_init(params)
        before = kadamw.launches
        with opcount.OpCounter() as c:
            adamw_update(_torch(_tree(4)), state, params, lr=1e-3,
                         scale=torch.tensor(0.5), kernels=kernels)
        assert kadamw.launches == before
        if kernels is ref.PLAIN:
            assert not c.kernels() and c.transcendentals == n
        else:
            assert c.kernels() == {"adamw": {"calls": leaves, "flops": 0,
                                             "bytes accessed": 28 * n + 16 * leaves,
                                             "transcendentals": n}}


def test_update_copies_a_gradient_that_is_not_contiguous():
    """A transposed gradient gives the bits of its contiguous copy."""
    g = torch.from_numpy(_tree(5)["w"]).t()
    assert not g.is_contiguous()
    out = []
    for grad in (g, g.contiguous()):
        params = {"w": torch.from_numpy(_tree(6)["w"]).t().contiguous()}
        state = adamw_init(params)
        out.append(adamw_update({"w": grad}, state, params, lr=1e-2)[0]["w"])
    assert torch.equal(out[0], out[1])


def _reduced_olmo():
    jcfg = jreduced(jget("olmo-1b"))
    tcfg = TC.reduced(TC.get_config("olmo-1b"))
    jshape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=16, global_batch=2)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), JP.init_params(
        jax.random.PRNGKey(0), j_get_module(jcfg).param_defs(jcfg)))
    return jcfg, tcfg, jshape, tree


def test_donated_step_is_the_jitted_donating_step():
    """``donated_train_step`` over 3 steps: the caller's own count tensor
    reads k after k calls, and every call returns the very parameter and
    moment tensors it was first given; metrics, parameters and moments
    within 2e-4 of ``jax.jit(build_train_step(...), donate_argnums=(0,
    1))``'s."""
    jcfg, tcfg, shape, tree = _reduced_olmo()
    jds = j_make_dataset(jcfg, shape, seed=3)
    tds = make_dataset(tcfg, TC.ShapeConfig("train_4k", "train", 16, 2), seed=3)
    jstep = jax.jit(j_build_train_step(jcfg, lr_schedule=joptim.warmup_cosine(1e-3, 2, 10)),
                    donate_argnums=(0, 1))
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = joptim.adamw_init(jp)
    params = from_jax_params(tree, get_module(tcfg).param_defs(tcfg), device="cpu")
    opt = adamw_init(params)
    count = opt.count
    held = tree_leaves((params, opt.m, opt.v))
    step = donated_train_step(build_train_step(tcfg, lr_schedule=warmup_cosine(1e-3, 2, 10)))
    for k in range(3):
        b = jds.batch(k)
        jp, jopt, jm = jstep(jp, jopt, {n: jnp.asarray(a) for n, a in b.items()})
        p2, o2, tm = step(params, opt, {n: torch.from_numpy(a) for n, a in tds.batch(k).items()})
        assert p2 is params and o2 is opt and o2.count is count
        assert all(a is b for a, b in zip(tree_leaves((p2, o2.m, o2.v)), held))
        assert int(count) == k + 1
        for key in ("loss", "grad_norm", "lr"):
            _close(tm[key], jm[key], 2e-4)
    for a, b in zip(tree_leaves((params, opt.m, opt.v)),
                    jax.tree.leaves((jp, jopt.m, jopt.v))):
        _close(a.detach(), b, 2e-4)


def test_donated_step_copies_other_tensors_into_the_donated_ones():
    """A call with other tensors (a checkpoint restored into fresh ones)
    has them copied into the donated buffers: 4 steps straight against 2,
    then the state after 2 given as fresh copies, then 2 more: the same
    bits, in the donated tensors."""
    _, tcfg, _, tree = _reduced_olmo()
    defs = get_module(tcfg).param_defs(tcfg)
    ds = make_dataset(tcfg, TC.ShapeConfig("train_4k", "train", 16, 2), seed=4)
    batches = [{n: torch.from_numpy(a) for n, a in ds.batch(k).items()} for k in range(4)]
    sched = warmup_cosine(1e-3, 2, 10)
    straight = from_jax_params(tree, defs, device="cpu")
    s_opt = adamw_init(straight)
    plain = build_train_step(tcfg, lr_schedule=sched)
    for b in batches:
        straight, s_opt, _ = plain(straight, s_opt, b)

    params = from_jax_params(tree, defs, device="cpu")
    opt = adamw_init(params)
    step = donated_train_step(build_train_step(tcfg, lr_schedule=sched))
    for b in batches[:2]:
        step(params, opt, b)
    for b in batches[2:]:
        fresh_p = tree_map(lambda t, path: t.detach().clone().requires_grad_(), params)
        fresh_o = AdamWState(opt.count.clone(), tree_map(lambda t, path: t.clone(), opt.m),
                             tree_map(lambda t, path: t.clone(), opt.v))
        got_p, got_o, _ = step(fresh_p, fresh_o, b)
        assert got_p is params and got_o is opt
    assert int(opt.count) == 4
    for a, b in zip(tree_leaves((params, opt.m, opt.v)), tree_leaves((straight, s_opt.m,
                                                                       s_opt.v))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="structure"):
        step({"w": torch.zeros(2)}, opt, batches[0])
