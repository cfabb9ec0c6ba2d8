"""The port's GPipe ring and data-parallel fan-out against the JAX
package's, on the CPU: ``runtime.pipeline`` in a world of 4 gloo
processes (``launch.mesh.spawn_local``, with its own time limit) against
JAX's sequential scan of the same numpy weights (``tests/test_pipeline.py``)
and against the function it fans out (``tests/test_serve.py::
test_data_parallel_matches_single_device``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.runtime.pipeline import bubble_fraction as j_bubble_fraction
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import pipeline
from repro_torch.runtime.collectives import mesh_mean

L_, D, B, M = 8, 16, 8, 4


def _stack_inputs():
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    W = np.asarray(jax.random.normal(ks[0], (L_, D, D)) * (0.5 / D ** 0.5))
    x = np.asarray(jax.random.normal(ks[1], (B, D)))
    return W, x


def _layer(w, h):
    return torch.tanh(h @ w) + h


def _block_fn(ws, h):            # one stage: its layers in turn
    for w in ws:
        h = _layer(w, h)
    return h


def _dp_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _pipeline_rank(W, x, params, xb):
    mesh = mesh_lib.make_mesh((1, 4), ("data", "model"), device="cpu")
    Wt = torch.from_numpy(W).requires_grad_()
    out = pipeline.gpipe(_block_fn, pipeline.split_stages(Wt, 4),
                         pipeline.microbatch(torch.from_numpy(x), M), mesh=mesh)
    (g,) = torch.autograd.grad((out ** 2).sum(), Wt)
    res = {"out": out.detach().reshape(B, D).numpy(),
           "grad": mesh_mean(g, mesh).numpy()}
    dmesh = mesh_lib.make_mesh((4,), ("data",), device="cpu")
    dp = pipeline.data_parallel(_dp_fn, mesh=dmesh)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    res["dp"] = dp(tparams, torch.from_numpy(xb)).numpy()
    try:
        dp(tparams, torch.from_numpy(xb[:6]))
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def test_gpipe_and_data_parallel_equal_the_reference():
    """On a (1, 4) world: ``gpipe`` of an 8-layer tanh stack over 4 stages
    and 4 microbatches equals JAX's sequential scan of the same W and x
    (2e-5), and the mean of the ranks' gradients of sum(out ** 2) equals
    ``jax.grad`` of it (2e-4), as ``tests/test_pipeline.py`` holds the
    reference.  On a ("data",) mesh of 4: ``data_parallel(fn)`` equals
    ``fn`` (JAX's, on the same numbers) within 1e-6 on every rank, and a
    batch of 6 raises "not divisible"."""
    W, x = _stack_inputs()

    def layer(w, h):
        return jnp.tanh(h @ w) + h

    def loss_ref(W):
        o = lax.scan(lambda c, w: (layer(w, c), None), x, W)[0]
        return (o ** 2).sum()

    ref = lax.scan(lambda c, w: (layer(w, c), None), x, W)[0]
    g_ref = jax.jit(jax.grad(loss_ref))(W)

    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    params = {"w": np.asarray(jax.random.normal(k0, (8, 8))), "b": np.ones(8, np.float32)}
    xb = np.asarray(jax.random.normal(k1, (16, 8)))
    want_dp = np.asarray(jnp.tanh(xb @ params["w"] + params["b"]))

    ranks = mesh_lib.spawn_local(4, _pipeline_rank, W, x, params, xb, device="cpu",
                                 timeout_s=90)
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(ref), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["grad"], np.asarray(g_ref), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["dp"], want_dp, atol=1e-6)
        assert "not divisible" in r["indivisible"]


def test_data_parallel_refuses_an_indivisible_batch_before_any_collective():
    mesh = mesh_lib.abstract_mesh((4,), ("data",), coords={"data": 0})
    dp = pipeline.data_parallel(_dp_fn, mesh=mesh)
    with pytest.raises(ValueError, match="batch 6 not divisible by data=4 shards"):
        dp({"w": torch.zeros(8, 8), "b": torch.zeros(8)}, torch.zeros(6, 8))


@pytest.mark.parametrize("n_micro,n_stages", [(1, 4), (16, 4), (64, 16), (4, 1), (7, 3)])
def test_bubble_fraction_equals_the_reference(n_micro, n_stages):
    assert pipeline.bubble_fraction(n_micro, n_stages) == \
        j_bubble_fraction(n_micro, n_stages)


def test_bubble_fraction_values():
    assert pipeline.bubble_fraction(1, 4) == pytest.approx(3 / 4)
    assert pipeline.bubble_fraction(16, 4) == pytest.approx(3 / 19)
    assert pipeline.bubble_fraction(64, 16) < 0.20


def test_split_stages_and_microbatch_shapes():
    W = torch.arange(8 * 3 * 2.0).reshape(8, 3, 2)
    st = pipeline.split_stages({"w": W}, 4)["w"]
    assert st.shape == (4, 2, 3, 2) and torch.equal(st[1, 0], W[2])
    assert pipeline.microbatch(torch.zeros(8, 5), 4).shape == (4, 2, 5)
    with pytest.raises(ValueError):
        pipeline.split_stages(W, 3)
