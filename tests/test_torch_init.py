"""The seeded init drawn on the device (``params.init_on_device`` and each
model's ``init_on_device``), on the CPU.

It draws every leaf with the initialisers and scales of the JAX package's
``init_params``, one generator a (leaf, layer slice), a stacked leaf one
layer slice at a time into its served dtype.  Its numbers are not the
reference's (``jax.random`` is another generator), so it is held to the
reference by distribution: each leaf of 4,096 elements or more within 5 %
of the std of ``repro.models.params.init_params`` at ``PRNGKey(0)`` (a
sample std of 4,096 normals is within ~1.1 % of its true value at one
sigma, so two independent ones differ by 5 % at ~3 sigma), zeros and ones
exact, ``uniform_decay`` in the reference's [-6, -3).  Reduced configs,
``device="cpu"``; the whole file takes a few seconds.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import get_module as jget_module
from repro.models import params as JP
from repro_torch import configs as TC
from repro_torch.models import get_module
from repro_torch.models import params as TP
from repro_torch.models import transformer as T

FIVE = ["starcoder2-15b", "minitron-4b", "olmo-1b", "qwen2-vl-2b",
        "qwen3-moe-30b-a3b"]
# the five, then the stacked and listed trees of the other families: RWKV-6
# holds the uniform_decay leaves
ARCHS = FIVE + ["rwkv6-1.6b", "recurrentgemma-2b", "seamless-m4t-large-v2"]


def _cfg(arch, dtype=None):
    cfg = TC.reduced(TC.get_config(arch))
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _leaves(tree) -> dict:
    out = {}
    TP.tree_map(lambda t, path: out.__setitem__(path, t), tree)
    return out


def test_the_same_seed_gives_the_same_bits_and_another_seed_others():
    cfg = _cfg("qwen3-moe-30b-a3b", "bfloat16")
    a, b = (_leaves(T.init_on_device(cfg, 3, device="cpu")) for _ in range(2))
    c = _leaves(T.init_on_device(cfg, 4, device="cpu"))
    for path in a:
        assert a[path].dtype == b[path].dtype and torch.equal(a[path], b[path]), path
    assert not torch.equal(a["blocks.moe.wi"], c["blocks.moe.wi"])
    # every draw has a generator of its own: two layer slices of a leaf and
    # two leaves of one shape differ
    assert not torch.equal(a["blocks.moe.wi"][0], a["blocks.moe.wi"][1])
    assert not torch.equal(a["blocks.attn.wk"], a["blocks.attn.wv"])


@pytest.mark.parametrize("arch", ["starcoder2-15b", "qwen3-moe-30b-a3b", "rwkv6-1.6b"])
def test_layers_n_are_the_first_slices_and_bf16_leaves_the_rounded_draw(arch):
    full = _cfg(arch)
    cfg = dataclasses.replace(full, num_layers=3)
    mod = get_module(cfg)
    f32 = _leaves(mod.init_on_device(cfg, 0, device="cpu"))
    one = _leaves(mod.init_on_device(cfg, 0, device="cpu", layers=1))
    bf16 = _leaves(mod.init_on_device(dataclasses.replace(cfg, dtype="bfloat16"), 0,
                                      device="cpu"))
    cast = TP.cast_paths(cfg, mod.COMPUTE_DTYPE_LEAVES)
    stacked = [p for p in f32 if p.startswith("blocks.")]
    assert stacked
    for path, t in f32.items():
        assert t.dtype == torch.float32 and one[path].dtype == torch.float32
        want = t[:1] if path in stacked else t
        assert torch.equal(one[path], want), path
        want = t.to(torch.bfloat16) if path in cast else t
        assert bf16[path].dtype == want.dtype and torch.equal(bf16[path], want), path
    # a config cut to 1 layer draws the same normals (one generator a leaf
    # index and layer index) at another scale: the reference's fan-in counts
    # the stacked layers' axis, so ``layers=`` is how a float32 check gets
    # the served weights' first layers
    cut = _leaves(mod.init_on_device(dataclasses.replace(cfg, num_layers=1), 0,
                                     device="cpu"))
    defs = {}
    TP.tree_map(lambda d, path: defs.__setitem__(path, d), mod.param_defs(cfg))
    scaled = [p for p in stacked if defs[p].init == "normal" and defs[p].scale is None]
    assert scaled
    for path in scaled:
        torch.testing.assert_close(cut[path], one[path] * 3 ** 0.5)


@pytest.mark.parametrize("arch", FIVE + ["rwkv6-1.6b", "seamless-m4t-large-v2"])
def test_structure_shapes_and_dtypes_are_load_params_of_a_numpy_tree(arch):
    cfg = _cfg(arch, "bfloat16")
    mod = get_module(cfg)
    want = _leaves(mod.load_params(cfg, TP.init_params(0, mod.param_defs(cfg)),
                                   device="cpu"))
    tree = mod.init_on_device(cfg, 0, device="cpu")
    got = _leaves(mod.load_params(cfg, tree, device="cpu"))
    assert list(got) == list(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert got[path].dtype == want[path].dtype, path
    # load_params takes the drawn tensors as they are: no copy
    drawn = _leaves(tree)
    assert all(got[p] is drawn[p] for p in got)
    if cfg.tie_embeddings:
        assert got["embed.embedding"].dtype == torch.float32


def test_recurrentgemma_init_matches_load_params_of_a_numpy_tree():
    from repro_torch.models import recurrentgemma
    cfg = _cfg("recurrentgemma-2b", "bfloat16")
    want = _leaves(recurrentgemma.load_params(
        cfg, TP.init_params(0, recurrentgemma.param_defs(cfg)), device="cpu"))
    got = _leaves(recurrentgemma.load_params(
        cfg, recurrentgemma.init_on_device(cfg, 0, device="cpu"), device="cpu"))
    assert {p: (t.shape, t.dtype) for p, t in got.items()} == {
        p: (t.shape, t.dtype) for p, t in want.items()}


def _jax_leaves(arch) -> dict:
    jcfg = jreduced(jget(arch))
    defs = jget_module(jcfg).param_defs(jcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        JP.init_params(jax.random.PRNGKey(0), defs),
        is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]
    norm = lambda k: re.sub(r"\['?([^'\]]+)'?\]", r".\1", k).lstrip(".")  # noqa: E731
    return {norm(jax.tree_util.keystr(k)): np.asarray(a, np.float32) for k, a in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_leaf_is_distributed_as_the_references(arch):
    cfg = _cfg(arch)
    mod = get_module(cfg)
    want = _jax_leaves(arch)
    got = {p: t.numpy() for p, t in _leaves(mod.init_on_device(cfg, 0, device="cpu")).items()}
    inits = {}
    TP.tree_map(lambda d, path: inits.__setitem__(path, d.init), mod.param_defs(cfg))
    assert set(got) == set(want)
    compared = 0
    for path, a in got.items():
        b, init = want[path], inits[path]
        assert a.shape == b.shape, path
        if init in ("zeros", "ones"):
            assert np.array_equal(a, np.full_like(a, init == "ones")), path
            assert np.array_equal(b, a), path
        elif init == "uniform_decay":
            assert a.min() >= -6.0 and a.max() < -3.0, path
            assert b.min() >= -6.0 and b.max() < -3.0, path
        elif a.size >= 4096:
            assert abs(a.std() / b.std() - 1) <= 0.05, (path, a.std(), b.std())
            assert abs(a.mean()) <= 5 * a.std() / np.sqrt(a.size), path
            compared += 1
    assert compared >= 4


def test_the_card_is_refused_without_one_and_tensor_leaves_skip_the_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_on_device(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.init_on_device(0, T.param_defs(cfg), device="cuda")
    leaf = torch.ones(3, 2, dtype=torch.bfloat16)
    out = TP.from_jax_params({"w": leaf}, {"w": TP.ParamDef((3, 2))}, device="cpu")
    assert out["w"] is leaf
    with pytest.raises(ValueError, match="expected"):
        TP.from_jax_params({"w": leaf}, {"w": TP.ParamDef((2, 3))}, device="cpu")
