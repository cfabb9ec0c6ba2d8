"""The 'cp' profile of the port's sharded train step against the JAX
package, on the CPU.

Under 'cp' the parameters are blocks over 'data' and whole over 'model',
and each batch row's sequence is split over 'model' where 'model' divides
it (``runtime.sharding.batch_pspecs``): a rank holds and computes S / n
consecutive tokens of its rows.  GSPMD changes no value, so every family's
'cp' step is held to JAX's UNSHARDED ``build_train_step`` (the reference's
own sharded step fails on the CPU: ``tests/test_torch_distribution.py``'s
docstring), on worlds of gloo processes (``launch.mesh.spawn_local``).
What the step rests on is held to the reference too: the attention's plain
versions at a query offset against rows of the reference's attention over
the whole sequence and its ``jax.vjp``, the WKV from a given state and its
gradient dS0 against ``jax.grad`` of the reference's jnp ``wkv_chunked``
from that state, and ``time_mix`` at T > 1 from a state.  Tolerances,
|a - b| <= tol (1 + |b|): 2e-4 (the JAX tests' own), 2e-5 for the
launcher against one process (sums in another order only).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.models import attention as JA
from repro.models import params as JP
from repro.models import rwkv6 as JR
from repro_torch import configs as TC
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as t_wkv
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import actshard, get_module
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models.params import init_params, tree_map
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.runtime import build_grad_fn, build_train_step, sharding
from test_torch_distribution import (FAMILIES, PARITY, TRAIN_ARCH, WORLD_S,
                                     _jax_steps, _jax_tree, _parity, _port_flat,
                                     _train_batches)

TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the kernels' plain versions at an offset and from a state
# ---------------------------------------------------------------------------

# causal, window, S (the whole sequence), offset, the rank's queries
_ATTN = {
    "causal": (True, None, 48, 24, 24),
    "causal_window_across_the_edge": (True, 8, 48, 24, 24),
    "causal_window_first_rows": (True, 8, 48, 16, 16),
    "noncausal": (False, None, 48, 0, 48),
    "noncausal_window": (False, 8, 48, 24, 24),
}


@pytest.mark.parametrize("case", list(_ATTN))
def test_attention_at_an_offset_is_rows_of_the_whole_sequence(case):
    """``ops.flash_attention`` with ``q_offset`` o on CPU tensors (its
    plain versions ``ref.attention_fwd_lse_ref`` / ``attention_bwd_ref``
    under ``FlashAttention``) on queries o ... o + Sq - 1 of a sequence,
    against rows [o, o + Sq) of the reference's ``flash_attention`` over
    the whole sequence and its ``jax.vjp`` with the cotangent on those rows:
    the output, dq, and dk / dv of the keys the rank reads (those up to its
    last query under ``causal``, as the 'cp' step cuts them), within 2e-4."""
    causal, window, S, o, sq = _ATTN[case]
    g = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (g.standard_normal((2, 2, S, 16)).astype(np.float32) for _ in range(3))
    cot = g.standard_normal((2, 2, sq, 16)).astype(np.float32)
    full_cot = np.zeros_like(q)
    full_cot[:, :, o:o + sq] = cot
    out, vjp = jax.vjp(lambda q, k, v: JA.flash_attention(q, k, v, causal, window,
                                                          None, 16, 16),
                       *(jnp.asarray(a) for a in (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(full_cot))
    nk = o + sq if causal else S
    tq = torch.from_numpy(q[:, :, o:o + sq].copy()).requires_grad_()
    tk = torch.from_numpy(k[:, :, :nk].copy()).requires_grad_()
    tv = torch.from_numpy(v[:, :, :nk].copy()).requires_grad_()
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=o)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), np.asarray(out)[:, :, o:o + sq])
    _close(tq.grad.numpy(), np.asarray(dq)[:, :, o:o + sq])
    _close(tk.grad.numpy(), np.asarray(dk)[:, :, :nk])
    _close(tv.grad.numpy(), np.asarray(dv)[:, :, :nk])
    assert not np.asarray(dk)[:, :, nk:].any()


def test_the_attention_wrappers_refuse_a_negative_offset_before_a_launch():
    """Both kernels' wrappers take 0 <= q_offset (a shard's queries never
    start before its keys) and raise on anything else before they launch
    or check a device."""
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import flash_attention_bwd as t_fb
    q = torch.zeros(1, 1, 4, 8)
    lse = torch.zeros(1, 1, 4)
    before = (t_fa.launches, t_fb.launches)
    for bad in (-1, 0.5):
        with pytest.raises(ValueError, match="q_offset"):
            t_fa.flash_attention(q, q, q, q_offset=bad)
        with pytest.raises(ValueError, match="q_offset"):
            t_fb.flash_attention_bwd(q, q, q, q, lse, q, q_offset=bad)
    assert (t_fa.launches, t_fb.launches) == before


def _flat(x):
    """[B,T,H,X] -> the kernel layout [B*H,T,X]."""
    B, T, H, X = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, X).contiguous()


# B, T, H, K, chunk, decay scale, whether the final state has a cotangent
_WKV = {
    "chunk8_T40": (2, 40, 2, 16, 8, 0.0, False),
    "chunk16_ragged_T50": (2, 50, 2, 16, 16, 0.0, True),
    "strong_decays": (1, 64, 4, 16, 32, 1.5, True),
}


@pytest.mark.parametrize("case", list(_WKV))
def test_wkv_from_a_state_matches_jax(case):
    """``ops.wkv_chunked`` from a nonzero state (float32 [BH,K,V]) on CPU
    tensors that require grad, so ``WKVChunked`` (``ref.wkv_ref``, then
    ``ref.wkv_bwd_ref``): the output, the final state, and dr, dk, dv,
    dlogw, du and dS0 against the reference's jnp ``wkv_chunked(..., state,
    chunk)`` and ``jax.grad`` of it, within 2e-4; the same call without a
    state gives what it gave before (no dS0)."""
    B, T, H, K, chunk, decay, use_state = _WKV[case]
    g = np.random.default_rng(sum(map(ord, case)))
    n = lambda *s, sc=0.5: (g.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    r, k, v = n(B, T, H, K), n(B, T, H, K), n(B, T, H, K)
    logw = -np.exp(decay + 0.5 * g.standard_normal((B, T, H, K))).astype(np.float32)
    u, s0 = n(H, K), n(B, H, K, K, sc=1.0)
    dout, ds = n(B, T, H, K, sc=1.0), n(B, H, K, K, sc=1.0)

    def loss(r, k, v, logw, u, s0):
        out, state = JR.wkv_chunked(r, k, v, logw, u, s0, chunk)
        return (out * dout).sum() + use_state * (state * ds).sum(), (out, state)

    (_, (want_out, want_state)), want = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
            *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (r, k, v, logw, u, s0)]
    tr, tk, tv, tw, tu, ts = leaves
    out, state = ops.wkv_chunked(_flat(tr), _flat(tk), _flat(tv), _flat(tw),
                                 tu.repeat(B, 1), chunk=chunk,
                                 state=ts.reshape(B * H, K, K))
    assert isinstance(out.grad_fn, t_wkv.WKVChunked._backward_cls)
    _close(out.detach().reshape(B, H, T, K).permute(0, 2, 1, 3).numpy(), want_out)
    _close(state.detach().reshape(B, H, K, K).numpy(), want_state)
    total = (out * _flat(torch.from_numpy(dout))).sum()
    if use_state:
        total = total + (state * torch.from_numpy(ds).reshape(B * H, K, K)).sum()
    total.backward()
    for name, leaf, w in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), leaves, want):
        assert leaf.grad is not None, name
        _close(leaf.grad.numpy(), np.asarray(w))
    with torch.no_grad():
        zero = ops.wkv_chunked(_flat(tr), _flat(tk), _flat(tv), _flat(tw),
                               tu.repeat(B, 1), chunk=chunk)
        same = ops.wkv_chunked(_flat(tr), _flat(tk), _flat(tv), _flat(tw),
                               tu.repeat(B, 1), chunk=chunk, state=None)
    assert all(torch.equal(a, b) for a, b in zip(zero, same))


def test_time_mix_at_t_above_one_from_a_state_matches_jax():
    """RWKV-6's ``time_mix`` (reduced: d 64, 4 heads of 16, chunk 8) at T = 20
    from a nonzero state, which raised before: the output, the final state
    and the gradients of x, of the state and of every time-mix weight
    against the reference's ``time_mix`` and ``jax.grad``, within 2e-4."""
    jcfg = jreduced(jget("rwkv6-1.6b"))
    tcfg = TC.reduced(TC.get_config("rwkv6-1.6b"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JP.init_params(jax.random.PRNGKey(0), JR.param_defs(jcfg)))
    tm = {k: a[0] for k, a in tree["blocks"]["tm"].items()}
    g = np.random.default_rng(21)
    x = g.standard_normal((2, 20, 64)).astype(np.float32)
    prev = g.standard_normal((2, 64)).astype(np.float32)
    s0 = g.standard_normal((2, 4, 16, 16)).astype(np.float32)
    cot = g.standard_normal((2, 20, 64)).astype(np.float32)
    cot_s = g.standard_normal((2, 4, 16, 16)).astype(np.float32)

    def loss(tm, x, s0):
        out, _, state = JR.time_mix(jcfg, tm, x, jnp.asarray(prev), s0, jcfg.wkv_chunk)
        return (out * cot).sum() + (state * cot_s).sum(), (out, state)

    (_, (want_out, want_state)), (want_tm, want_x, want_s0) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            {n: jnp.asarray(a) for n, a in tm.items()}, jnp.asarray(x), jnp.asarray(s0))
    ttm = {n: torch.from_numpy(a.copy()).requires_grad_() for n, a in tm.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    ts = torch.from_numpy(s0.copy()).requires_grad_()
    out, _, state = R.time_mix(tcfg, ttm, tx, torch.from_numpy(prev), ts, tcfg.wkv_chunk)
    _close(out.detach().numpy(), want_out)
    _close(state.detach().numpy(), want_state)
    ((out * torch.from_numpy(cot)).sum()
     + (state * torch.from_numpy(cot_s)).sum()).backward()
    _close(tx.grad.numpy(), want_x)
    _close(ts.grad.numpy(), want_s0)
    for n, leaf in ttm.items():
        assert leaf.grad is not None, n
        _close(leaf.grad.numpy(), np.asarray(want_tm[n]))


# ---------------------------------------------------------------------------
# the 'cp' train step on worlds of gloo processes
# ---------------------------------------------------------------------------

WINDOW = 8          # h2o's window cut so that it crosses the shard's edge
RAGGED = 31         # a sequence that 'model' = 2 does not divide


def _batches(jcfg, seq):
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=seq, global_batch=4)
    ds = j_make_dataset(jcfg, shape, seed=11)
    return [ds.batch(s) for s in range(3)]


@pytest.fixture(scope="module")
def jax_cp():
    """Each family's tree, 4 x 32 batches and JAX's unsharded three steps
    (as ``test_torch_distribution``'s ``jax_train``); h2o with the window
    cut to 8 on both sides under "window", and h2o's 4 x 31 batches under
    "ragged"."""
    out = {}
    for arch in FAMILIES:
        jcfg = jreduced(jget(arch))
        tree, batches = _jax_tree(jcfg), _train_batches(jcfg)
        out[arch] = (tree, batches, _jax_steps(jcfg, tree, batches))
    jcfg = jreduced(jget(TRAIN_ARCH))
    tree, batches = out[TRAIN_ARCH][0], out[TRAIN_ARCH][1]
    wcfg = dataclasses.replace(jcfg, window=WINDOW)
    out["window"] = (tree, batches, _jax_steps(wcfg, tree, batches))
    ragged = _batches(jcfg, RAGGED)
    out["ragged"] = (tree, ragged, _jax_steps(jcfg, tree, ragged))
    return out


def _cfg(name):
    cfg = TC.reduced(TC.get_config(TRAIN_ARCH if name in ("window", "ragged") else name))
    return dataclasses.replace(cfg, window=WINDOW) if name == "window" else cfg


def _cp_run(name, mesh, tree, batches, probe=False):
    """Three 'cp' steps of ``name``'s config on the rank's blocks of ``tree``
    -> (losses, the gathered parameters, the optimizer's count, whether the
    layout split the sequence, with ``probe`` the FLOPs of one ``grad_fn``
    and of one process's on the whole batch)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _cfg(name)
    step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=mesh,
                            profile="cp")
    params = tree_map(lambda a, s, path: torch.from_numpy(np.array(   # a copy
        sharding.local_shard(a, s, mesh))).requires_grad_(), tree, step.pspecs)
    opt = adamw_init(params)
    losses, seen = [], {}
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    if probe:
        tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        with FlopCounterMode(display=False) as fc:
            step.grad_fn(params, tb)
        mine = fc.get_total_flops()
        whole = tree_map(lambda a, path: torch.from_numpy(a.copy()), tree)
        with FlopCounterMode(display=False) as fc:
            build_grad_fn(cfg)(whole, tb)
        seen["flops"] = (mine, fc.get_total_flops())
    full = sharding.tree_gather_full(params, step.pspecs, mesh)
    return losses, _port_flat(tree_map(lambda t, path: t.detach().numpy(), full)), \
        int(opt.count), seen


def _moe_claims(mesh):
    """One reduced qwen2-moe MoE layer at capacity 0.5 (claims dropped) on
    the rank's block of a 4 x 32 batch under a 'cp' layout, and the same
    layer with no layout on the whole batch: (the rank's output, its aux,
    the whole batch's output cut to the rank's block, its aux)."""
    cfg = TC.reduced(TC.get_config("qwen2-moe-a2.7b"))
    defs = get_module(cfg).param_defs(cfg)
    moe = tree_map(lambda a, path: torch.from_numpy(np.ascontiguousarray(a[0])),
                   init_params(3, defs)["blocks"]["moe"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    layout = sharding.Layout(cfg, mesh, defs, "cp")
    labels = sharding.batch_pspecs(cfg, mesh, {"labels": x[..., 0]}, "cp")["labels"]
    layout.set_batch({"labels": labels})
    block = sharding.P(labels[0], "model", None)
    actshard.set_mesh(mesh, "cp", layout)
    try:
        out, aux = L.moe_apply(cfg, moe, sharding.local_shard(x, block, mesh),
                               capacity_factor=0.5)
    finally:
        actshard.set_mesh(None)
    whole, whole_aux = L.moe_apply(cfg, moe, x, capacity_factor=0.5)
    return (out.numpy(), float(aux), sharding.local_shard(whole, block, mesh).numpy(),
            float(whole_aux))


def _four_rank(refs):
    """One rank of the (data 2, model 2) world: every family under 'cp', and
    the MoE's claims."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in FAMILIES:
        tree, batches, ref = refs[arch]
        losses, flat, count, _ = _cp_run(arch, mesh, tree, batches)
        out[arch] = (_parity(losses, flat, ref), count)
    out["moe"] = _moe_claims(mesh)
    return out


def _two_rank(refs):
    """One rank of the (data 1, model 2) world: every family under 'cp' (h2o
    with the FLOP count), h2o with a window of 8 and on 4 x 31."""
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {}
    for name in FAMILIES + ("window", "ragged"):
        tree, batches, ref = refs[name]
        losses, flat, count, seen = _cp_run(name, mesh, tree, batches,
                                            probe=name == TRAIN_ARCH)
        out[name] = (_parity(losses, flat, ref), count, seen)
    return out


@pytest.fixture(scope="module")
def cp_worlds(jax_cp):
    four = mesh_lib.spawn_local(4, _four_rank, jax_cp, device="cpu",
                                timeout_s=4 * WORLD_S)
    two = mesh_lib.spawn_local(2, _two_rank, jax_cp, device="cpu", timeout_s=2 * WORLD_S)
    return four, two


def _held(result, what):
    (loss_err, param_err, worst), count = result[:2]
    assert count == 3, what
    assert loss_err <= PARITY, f"{what}: loss error {loss_err:.3e}"
    assert param_err <= PARITY, f"{what}: {worst} error {param_err:.3e}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_under_cp_holds_the_unsharded_reference(cp_worlds, arch):
    """Each family's reduced config under 'cp' on (data 2, model 2) and on
    (1, 2), three steps of 4 x 32 (16 tokens a rank): the losses and every
    parameter within 2e-4 (1 + |b|) of JAX's unsharded step on every rank
    (attention over K / V gathered over 'model' at the rank's offset, the
    WKV and RG-LRU states and the token shifts and convolution inputs
    handed from rank to rank, the MoE routed in the global token order)."""
    four, two = cp_worlds
    for r, rank in enumerate(four):
        _held(rank[arch], f"{arch} (2, 2) rank {r}")
    for r, rank in enumerate(two):
        _held(rank[arch], f"{arch} (1, 2) rank {r}")


def test_a_window_across_the_shard_edge_holds_the_reference(cp_worlds):
    """h2o with its window cut to 8 on both sides (the reduced window of 32
    never crosses the edge at 32 tokens) on (1, 2): rank 1's first queries
    see keys of rank 0 within the window, none before it; three steps
    within 2e-4 (1 + |b|) of JAX's unsharded step."""
    _, two = cp_worlds
    for r, rank in enumerate(two):
        _held(rank["window"], f"window {WINDOW} rank {r}")


def test_a_sequence_model_does_not_divide_holds_the_reference(cp_worlds):
    """h2o on 4 x 31 on (1, 2): 'model' does not divide the sequence, so both
    ranks hold every token and nothing is summed over 'model' (a sum would
    double every gradient); three steps within 2e-4 (1 + |b|) of JAX's."""
    _, two = cp_worlds
    for r, rank in enumerate(two):
        _held(rank["ragged"], f"4 x {RAGGED} rank {r}")


def test_moe_claims_under_cp_take_the_global_token_order(cp_worlds):
    """qwen2-moe's MoE layer at capacity 0.5 under 'cp' on (2, 2): each
    rank's output is its block of the plain layer's on the whole batch,
    and its aux the whole batch's: a claim's place in its expert counts
    every earlier row's claims and this row's on the lower rank of
    'model', so the same claims are dropped."""
    four, _ = cp_worlds
    for r, rank in enumerate(four):
        out, aux, want, want_aux = rank["moe"]
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        assert abs(aux - want_aux) <= 1e-6 * (1 + abs(want_aux)), (r, aux, want_aux)


def test_a_rank_under_cp_computes_about_half_the_flops(cp_worlds):
    """``FlopCounterMode`` over one ``grad_fn`` of h2o reduced under 'cp' on
    (1, 2): each rank's count 0.4-0.55 of one process's on the whole batch
    (the products split by tokens; rank 1's attention reads twice rank 0's
    keys, and each rank's plain attention runs whole score blocks)."""
    _, two = cp_worlds
    for r, rank in enumerate(two):
        mine, whole = rank[TRAIN_ARCH][2]["flops"]
        assert 0.4 * whole <= mine <= 0.55 * whole, (r, mine, whole)


def test_launcher_under_cp_resumes_and_changes_no_value(tmp_path):
    """``launch.train --mesh 1x2 --profile cp`` on two ranks, checkpointed
    after step 2 (its final checkpoint taken away), then resumed for the
    third step: the final checkpoint equals a one-device run of 3 steps
    within 2e-5 (sums in another order, no other difference)."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    common = ["--arch", "olmo-1b", "--reduced", "--batch", "4", "--seq", "16",
              "--device", "cpu", "--warmup", "1", "--steps", "3"]
    one, two = tmp_path / "one", tmp_path / "two"
    train.main(common + ["--ckpt-dir", str(one)])
    cp = ["--mesh", "1x2", "--profile", "cp"]
    mesh_lib.spawn_local(2, train.main, common + ["--ckpt-dir", str(two), "--ckpt-every",
                                                  "2"] + cp, device="cpu", timeout_s=WORLD_S)
    shutil.rmtree(two / "step_00000003")
    mesh_lib.spawn_local(2, train.main, common + ["--ckpt-dir", str(two)] + cp,
                         device="cpu", timeout_s=WORLD_S)
    _, want = load_checkpoint(one, 3)
    _, got = load_checkpoint(two, 3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-5, err_msg=k)
