"""The port's distributed runtime against the JAX package's, on the CPU.

Specs (``model_param_pspecs``, ``batch_pspecs``, ``cache_pspecs``) are held
to the reference's entry for entry with no devices: the JAX side gets a
stand-in mesh with ``axis_names`` and ``devices.shape``, all that
``repro/runtime/sharding.py`` reads.  Layouts, the sharded MoE on a (2, 2)
mesh and the compressed pod all-reduce are held to JAX on forced host
devices in one subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``tests/test_distribution.py`` runs them).  The port's per-rank programs
run in real worlds of gloo processes on the CPU (``launch.mesh.spawn_local``,
each world with its own time limit).

The sharded train step is held to the JAX package's UNSHARDED
``build_train_step``: the reference's own sharded step fails on the CPU
(``tests/test_distribution.py::test_train_step_on_2d_mesh_multidevice``
raises ``ShardingTypeError`` at ``repro/models/layers.py:438``, where JAX
cannot resolve the output sharding of the embedding's gather), and GSPMD
changes no value, so a mesh must change none either.  The one exception is
the MoE under '2d' / 'tp' with more than one data shard: there the
reference's ``moe_apply_sharded`` routes each shard with its own capacity,
so the MoE family is held to JAX's step with its mesh installed
(``actshard.set_mesh`` on forced host devices, the parameters unsharded),
which runs that layer under ``shard_map``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.data.synthetic import make_dataset as j_make_dataset
from repro.launch.specs import input_specs as j_input_specs
from repro.models import get_module as j_get_module
from repro.models import layers as JL
from repro.models import params as JP
from repro.optim import adamw_init as j_adamw_init
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime import build_train_step as j_build_train_step
from repro.runtime import sharding as JS
from repro_torch import configs as TC
from repro_torch.checkpoint import restore_sharded, save_checkpoint
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import input_specs
from repro_torch.models import actshard, get_module
from repro_torch.models import layers as L
from repro_torch.models import moe_sharded
from repro_torch.models import params as TP
from repro_torch.models.params import PartitionSpec as P
from repro_torch.models.params import from_jax_params, init_params, tree_map
from repro_torch.optim import AdamWState, adamw_init, warmup_cosine
from repro_torch.optim.compression import compressed_pod_allreduce
from repro_torch.runtime import build_grad_fn, build_train_step, sharding
from repro_torch.runtime.collectives import psum

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=8")
WORLD_S = 120           # each spawned world's time limit
MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")


def _spawn(n, fn, *args):
    return mesh_lib.spawn_local(n, fn, *args, device="cpu", timeout_s=WORLD_S)


def _part(k):      # a dict key, a NamedTuple field or a list index
    return str(next(getattr(k, a) for a in ("key", "name", "idx") if hasattr(k, a)))


def _jax_flat(tree, is_leaf=None):
    return {".".join(_part(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _port_flat(tree):
    out = {}
    tree_map(lambda leaf, path: out.__setitem__(path, leaf), tree)
    return out


def _stand_in(shape, names):
    """What ``repro/runtime/sharding.py`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.empty(shape, dtype=object))


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# specs, no devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", JS.PROFILES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_equal_the_reference(arch, profile):
    """Every arch x profile on the (16, 16) production mesh: each leaf's
    logical axes and its PartitionSpec equal the JAX package's."""
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    jdefs = j_get_module(jcfg).param_defs(jcfg)
    tdefs = get_module(tcfg).param_defs(tcfg)
    jd = _jax_flat(jdefs, is_leaf=lambda x: isinstance(x, JP.ParamDef))
    td = _port_flat(tdefs)
    assert sorted(jd) == sorted(td)
    for path, d in td.items():
        assert d.axes == jd[path].axes and d.shape == jd[path].shape, path
    want = _jax_flat(JS.model_param_pspecs(jcfg, _stand_in((16, 16), ("data", "model")),
                                           jdefs, profile=profile), is_leaf=_is_jspec)
    got = _port_flat(sharding.model_param_pspecs(
        tcfg, mesh_lib.abstract_mesh((16, 16), ("data", "model")), tdefs,
        profile=profile))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert isinstance(spec, P) and tuple(spec) == tuple(want[path]), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_pspecs_equal_the_reference(arch):
    """Each arch's train inputs, every profile, meshes with and without a
    pod axis, batches the dp axes divide and batches they do not."""
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    for shape, names in (((16, 16), ("data", "model")), ((2, 4), ("data", "model")),
                         ((2, 2, 4), ("pod", "data", "model"))):
        for B, S in ((256, 64), (6, 32), (8, 48)):
            jshape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=S,
                                         global_batch=B)
            jstruct = j_input_specs(jcfg, jshape)
            tstruct = input_specs(tcfg, TC.ShapeConfig("train_4k", "train", S, B))
            assert sorted(jstruct) == sorted(tstruct)
            for profile in JS.PROFILES:
                want = JS.batch_pspecs(jcfg, _stand_in(shape, names), jstruct, profile)
                got = sharding.batch_pspecs(tcfg, mesh_lib.abstract_mesh(shape, names),
                                            tstruct, profile)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (shape, B, S, profile)


def _prefill_batch(cfg, B, S, rng, xp):
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": xp(tokens)}
    if cfg.family == "audio":
        batch["inputs_embeds"] = xp(rng.standard_normal((B, S, cfg.d_model))
                                    .astype(np.float32))
        batch["tokens"] = xp(np.ascontiguousarray(tokens[:, :1]))
    return batch


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2", "recurrentgemma-2b"])
def test_cache_pspecs_equal_the_reference(arch):
    """One cache of each family, made by each side's own prefill at
    ``reduced`` size (the JAX one abstractly, ``jax.eval_shape``), over
    meshes whose 'model' axis divides some of its dims and not others."""
    jcfg, tcfg = jreduced(jget(arch)), TC.reduced(TC.get_config(arch))
    jmod, tmod = j_get_module(jcfg), get_module(tcfg)
    B, S = 4, 12
    jbatch = _prefill_batch(jcfg, B, S, np.random.default_rng(0),
                            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype))
    jcache = jax.eval_shape(lambda p, b: jmod.prefill(jcfg, p, b)[1],
                            JP.abstract_params(jmod.param_defs(jcfg)), jbatch)
    tparams = from_jax_params(init_params(0, tmod.param_defs(tcfg)), device="cpu")
    tbatch = _prefill_batch(tcfg, B, S, np.random.default_rng(0), torch.from_numpy)
    with torch.inference_mode():
        tcache = tmod.prefill(tcfg, tparams, tbatch)[1]
    assert type(tcache)._fields == type(jcache)._fields
    for shape, names in (((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                         ((2, 2, 3), ("pod", "data", "model"))):
        for profile in JS.PROFILES:
            want = JS.cache_pspecs(jcfg, _stand_in(shape, names), jcache, profile)
            got = sharding.cache_pspecs(tcfg, mesh_lib.abstract_mesh(shape, names),
                                        tcache, profile)
            for field in type(tcache)._fields:
                w = jax.tree.leaves(getattr(want, field), is_leaf=_is_jspec)
                g = getattr(got, field)
                g = g if isinstance(g, list) else [g]
                assert [tuple(s) for s in g] == [tuple(s) for s in w], \
                    (field, shape, profile)


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_validate_pspecs_raises_as_the_reference():
    """Rules that put 'data' = 3 on d_model 64 without the demotions: each
    leaf on its own raises ``ValueError`` with the reference's message, or
    passes where the reference passes (the two walk a tree in another
    order, so a whole tree's first message may name another leaf)."""
    jcfg, tcfg = jreduced(jget("h2o-danube-1.8b")), TC.reduced(TC.get_config("h2o-danube-1.8b"))
    sizes = {"data": 3, "model": 2}
    kw = dict(kv_heads=jcfg.num_kv_heads, num_heads=jcfg.num_heads)
    jrules, trules = JP.resolve_rules(sizes, **kw), TP.resolve_rules(sizes, **kw)
    assert jrules == trules
    jd = _jax_flat(j_get_module(jcfg).param_defs(jcfg),
                   is_leaf=lambda x: isinstance(x, JP.ParamDef))
    td = _port_flat(get_module(tcfg).param_defs(tcfg))
    raised = 0
    for path, d in td.items():
        want = _raised(lambda: JP.validate_pspecs({"x": jd[path]}, jrules, sizes))
        assert _raised(lambda: TP.validate_pspecs({"x": d}, trules, sizes)) == want, path
        raised += want is not None
    assert raised > 5
    with pytest.raises(ValueError, match="not divisible by mesh axes data"):
        TP.validate_pspecs(get_module(tcfg).param_defs(tcfg), trules, sizes)
    TP.validate_pspecs(get_module(tcfg).param_defs(tcfg),
                       TP.resolve_rules({"data": 2, "model": 2}, **kw),
                       {"data": 2, "model": 2})


# ---------------------------------------------------------------------------
# the reference on forced host devices, once for the module
# ---------------------------------------------------------------------------


def _moe_inputs(arch):
    cfg = jreduced(jget(arch))
    tree = _np_tree(JP.init_params(jax.random.PRNGKey(0), JL.moe_defs(cfg)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, cfg.d_model)))
    return tree, x


def _pod_inputs():
    rng = np.random.default_rng(3)
    grads = {"w": rng.standard_normal((2, 6, 5)).astype(np.float32),
             "b": rng.standard_normal((2, 7)).astype(np.float32)}
    fb = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in grads.items()}
    return grads, fb


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """One subprocess on 8 forced host devices: the slices
    ``NamedSharding.devices_indices_map`` gives each device of a (2, 4)
    mesh for every parameter of olmo-1b and qwen2-moe-a2.7b (reduced), by
    the device's mesh coordinates; ``moe_apply_sharded`` on (2, 2); and
    ``compressed_pod_allreduce`` on a 2-device ("pod",) mesh; and
    qwen2-moe's three train steps of JAX's ``build_train_step`` with its
    (2, 2) mesh installed (``actshard.set_mesh``), whose MoE layers run
    ``moe_apply_sharded`` under ``shard_map`` (the parameters unsharded),
    as the MoE family's reference under '2d' and 'tp'."""
    d = tmp_path_factory.mktemp("forced")
    arrays = {}
    for arch in MOE_ARCHS:
        tree, x = _moe_inputs(arch)
        arrays.update({f"moe/{arch}/p/{k}": v for k, v in _jax_flat(tree).items()})
        arrays[f"moe/{arch}/x"] = x
    grads, fb = _pod_inputs()
    arrays.update({f"pod/g/{k}": v for k, v in grads.items()})
    arrays.update({f"pod/r/{k}": v for k, v in fb.items()})
    np.savez(d / "in.npz", **arrays)
    code = f"""
    import json, numpy as np, jax
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_config, reduced
    from repro.models import get_module, params as PL
    from repro.models.moe_sharded import moe_apply_sharded
    from repro.optim.compression import compressed_pod_allreduce
    from repro.runtime import model_param_pspecs
    from repro.runtime.sharding import PartitionSpec_cls as P
    inp = dict(np.load({str(d / 'in.npz')!r}))
    out, slices = {{}}, {{}}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    coords = {{dev: tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0])
              for dev in mesh.devices.flat}}
    for arch in ("olmo-1b", "qwen2-moe-a2.7b"):
        cfg = reduced(get_config(arch))
        defs = get_module(cfg).param_defs(cfg)
        specs = model_param_pspecs(cfg, mesh, defs)
        flat = jax.tree_util.tree_flatten_with_path(
            defs, is_leaf=lambda x: isinstance(x, PL.ParamDef))[0]
        sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        for (path, d), spec in zip(flat, sflat):
            key = arch + ":" + ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                        for k in path)
            idx = NamedSharding(mesh, spec).devices_indices_map(d.shape)
            slices[key] = [[list(coords[dev]), [[s.start or 0, d.shape[i] if
                            s.stop is None else s.stop] for i, s in enumerate(sl)]]
                           for dev, sl in idx.items()]
    m22 = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    for arch in {MOE_ARCHS!r}:
        cfg = reduced(get_config(arch))
        pre = "moe/" + arch + "/p/"
        tree = {{}}
        for k, v in inp.items():
            if k.startswith(pre):
                node, parts = tree, k[len(pre):].split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {{}})
                node[parts[-1]] = v
        o, a = jax.jit(lambda p, x: moe_apply_sharded(cfg, p, x, mesh=m22))(
            tree, inp["moe/" + arch + "/x"])
        out["moe22/" + arch + "/out"] = np.asarray(o)
        out["moe22/" + arch + "/aux"] = np.asarray(a)
    from repro.data.synthetic import make_dataset
    from repro.configs import SHAPES_BY_NAME
    from repro.models import actshard
    from repro.optim import adamw_init, warmup_cosine
    from repro.runtime import build_train_step
    import dataclasses, jax.numpy as jnp
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    ds = make_dataset(cfg, dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=32,
                                               global_batch=4), seed=11)
    mp = jax.jit(lambda k: PL.init_params(k, get_module(cfg).param_defs(cfg)))(
        jax.random.PRNGKey(0))
    actshard.set_mesh(jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                                    axis_types=(jax.sharding.AxisType.Auto,) * 2), "2d")
    mstep = jax.jit(build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10)))
    mopt, losses = adamw_init(mp), []
    for s in range(3):
        mp, mopt, mm = mstep(mp, mopt, {{k: jnp.asarray(v) for k, v in ds.batch(s).items()}})
        losses.append(float(mm["loss"]))
    actshard.set_mesh(None)
    out["moestep/losses"] = np.array(losses)
    for path, leaf in jax.tree_util.tree_flatten_with_path(mp)[0]:
        out["moestep/p/" + ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                    for k in path)] = np.asarray(leaf, np.float32)
    pod = Mesh(np.array(jax.devices()[:2]), ("pod",))
    g = {{k[6:]: inp[k] for k in inp if k.startswith("pod/g/")}}
    r = {{k[6:]: inp[k] for k in inp if k.startswith("pod/r/")}}
    mean, fb = compressed_pod_allreduce(g, r, pod)
    for k in g:
        out["pod/mean/" + k] = np.asarray(mean[k])
        out["pod/fb/" + k] = np.asarray(fb[k])
    np.savez({str(d / 'out.npz')!r}, **out)
    open({str(d / 'slices.json')!r}, "w").write(json.dumps(slices))
    print("forced OK", jax.device_count())
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=ENV, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0 and "forced OK 8" in r.stdout, r.stderr[-3000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "slices.json").read_text())


def test_local_shard_is_the_device_slice_of_named_sharding(forced):
    """Every parameter of olmo-1b and qwen2-moe-a2.7b (reduced) on a (2, 4)
    mesh: ``local_shard`` at each mesh coordinate is the block that
    ``NamedSharding(mesh, spec).devices_indices_map`` gives the device at
    those coordinates."""
    _, slices = forced
    n = 0
    for arch in ("olmo-1b", "qwen2-moe-a2.7b"):
        cfg = TC.reduced(TC.get_config(arch))
        defs = get_module(cfg).param_defs(cfg)
        specs = _port_flat(sharding.model_param_pspecs(
            cfg, mesh_lib.abstract_mesh((2, 4), ("data", "model")), defs))
        for path, d in _port_flat(defs).items():
            full = np.arange(np.prod(d.shape)).reshape(d.shape)
            entries = slices[f"{arch}:{path}"]
            assert len(entries) == 8
            for coords, sl in entries:
                mesh = mesh_lib.abstract_mesh((2, 4), ("data", "model"),
                                              coords=dict(zip(("data", "model"), coords)))
                want = full[tuple(slice(a, b) for a, b in sl)]
                np.testing.assert_array_equal(sharding.local_shard(full, specs[path], mesh),
                                              want, err_msg=f"{arch}:{path} {coords}")
                n += 1
    assert n > 100


# ---------------------------------------------------------------------------
# the expert-parallel MoE
# ---------------------------------------------------------------------------


def _moe_rank(shape, cases, grads):
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), device="cpu")
    return {arch: _moe_case(mesh, arch, *case, grads) for arch, case in cases.items()}


def _moe_case(mesh, arch, tree, x, w, grads):
    cfg = TC.reduced(TC.get_config(arch))
    params = from_jax_params(tree, L.moe_defs(cfg), device="cpu")
    leaves = TP.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(grads)
    xt = sharding.local_shard(torch.from_numpy(x).reshape(-1, cfg.d_model),
                              P("data", None), mesh)
    out, aux = moe_sharded.moe_apply_sharded(cfg, params, xt, mesh=mesh)
    res = {"coords": mesh.coords, "out": out.detach().numpy(), "aux": float(aux)}
    if grads:
        wl = sharding.local_shard(torch.from_numpy(w), P("data", None), mesh)
        g = torch.autograd.grad((out * wl).sum() + aux, leaves)
        it = iter(g)
        res["grads"] = _port_flat(tree_map(
            lambda p, path: _whole_grad(next(it), path, mesh).numpy(), params))
    return res


def _whole_grad(g, path, mesh):
    """A tensor-parallel layer's gradient of a leaf it is given whole: the
    sum over 'model' of the ranks' blocks (zeros outside them) for the
    experts and the shared experts, which the ranks split; the rank's own
    for the router and the shared gate, which each uses whole."""
    if path.split(".")[-1] in ("wi", "wg", "wo"):
        return psum(g, mesh, "model")
    return g


def test_sharded_moe_equals_the_plain_layer_on_1x4():
    """On (data 1, model 4) each rank runs one of the 4 padded experts: the
    output equals JAX's plain ``moe_apply`` within 3e-4 and the aux within
    1e-4 relative (the capacity is the global one), and the ranks'
    gradients (``_whole_grad``: the layer is tensor-parallel over 'model')
    equal autograd of the port's plain ``moe_apply`` within 3e-4, both
    reduced MoE configs."""
    cases = {}
    for arch in MOE_ARCHS:
        tree, x = _moe_inputs(arch)
        w = np.random.default_rng(5).standard_normal((32, x.shape[-1])).astype(np.float32)
        cases[arch] = (tree, x, w)
    worlds = _spawn(4, _moe_rank, (1, 4), cases, True)
    for arch, (tree, x, w) in cases.items():
        jcfg, tcfg = jreduced(jget(arch)), TC.reduced(TC.get_config(arch))
        o_ref, a_ref = jax.jit(lambda p, x: JL.moe_apply(jcfg, p, x))(tree, x)
        ranks = [world[arch] for world in worlds]
        plain = from_jax_params(tree, L.moe_defs(tcfg), device="cpu")
        leaves = TP.tree_leaves(plain)
        for p in leaves:
            p.requires_grad_(True)
        po, pa = L.moe_apply(tcfg, plain, torch.from_numpy(x).reshape(-1, tcfg.d_model))
        g = iter(torch.autograd.grad((po * torch.from_numpy(w)).sum() + pa, leaves))
        want = _port_flat(tree_map(lambda p, path: next(g).numpy(), plain))
        for r in ranks:
            np.testing.assert_allclose(r["out"].reshape(x.shape), np.asarray(o_ref),
                                       rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(r["aux"], float(a_ref), rtol=1e-4)
            assert sorted(r["grads"]) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(r["grads"][k], v, rtol=3e-4, atol=3e-4,
                                           err_msg=f"{arch} {k}")


def test_sharded_moe_equals_the_reference_sharded_on_2x2(forced):
    """On (data 2, model 2) each token shard takes its own capacity: the
    port equals JAX's ``moe_apply_sharded`` on a forced (2, 2) mesh."""
    out, _ = forced
    cases = {arch: (*_moe_inputs(arch), None) for arch in MOE_ARCHS}
    worlds = _spawn(4, _moe_rank, (2, 2), cases, False)
    for arch, (tree, x, _) in cases.items():
        ranks = [world[arch] for world in worlds]
        by_data = {r["coords"]["data"]: r for r in ranks if r["coords"]["model"] == 0}
        got = np.concatenate([by_data[0]["out"], by_data[1]["out"]]).reshape(x.shape)
        np.testing.assert_allclose(got, out[f"moe22/{arch}/out"], rtol=3e-4, atol=3e-4)
        for r in ranks:
            np.testing.assert_allclose(r["aux"], out[f"moe22/{arch}/aux"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube-1.8b"
# one reduced config a family: dense, tied head (olmo's non-parametric norm),
# VLM (M-RoPE, inputs_embeds), MoE, encoder-decoder, RWKV-6, RecurrentGemma
FAMILIES = ("h2o-danube-1.8b", "olmo-1b", "qwen2-vl-2b", "qwen2-moe-a2.7b",
            "seamless-m4t-large-v2", "rwkv6-1.6b", "recurrentgemma-2b")
TRAIN_PROFILES = ("2d", "tp", "fsdp")
PARITY = 2e-4           # |port - JAX| <= PARITY (1 + |JAX|), losses and parameters


def _train_batches(jcfg, mask=False):
    """Three global batches of 4 x 32 from the reference's dataset; with
    ``mask`` a seeded loss_mask that drops about a third of the tokens."""
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=32, global_batch=4)
    ds = j_make_dataset(jcfg, shape, seed=11)
    out = [ds.batch(s) for s in range(3)]
    if mask:
        rng = np.random.default_rng(12)
        for b in out:
            b["loss_mask"] = (rng.random(b["labels"].shape) > 0.35).astype(np.float32)
    return out


def _jax_steps(jcfg, tree, batches):
    """JAX's unsharded ``build_train_step``: (losses, flat parameters)."""
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = j_adamw_init(jp)
    jstep = jax.jit(j_build_train_step(jcfg, lr_schedule=j_warmup_cosine(1e-3, 2, 10)))
    losses = []
    for b in batches:
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(jm["loss"]))
    return losses, {k: np.asarray(v) for k, v in _jax_flat(jp).items()}


def _jax_tree(jcfg):
    return _np_tree(jax.jit(lambda k: JP.init_params(
        k, j_get_module(jcfg).param_defs(jcfg)))(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_train():
    """Each family's tree, batches and JAX unsharded three steps; h2o's
    masked batches and their JAX steps under "masked"."""
    out = {}
    for arch in FAMILIES:
        jcfg = jreduced(jget(arch))
        tree, batches = _jax_tree(jcfg), _train_batches(jcfg)
        out[arch] = (tree, batches, _jax_steps(jcfg, tree, batches))
    jcfg = jreduced(jget(TRAIN_ARCH))
    masked = _train_batches(jcfg, mask=True)
    out["masked"] = (out[TRAIN_ARCH][0], masked, _jax_steps(jcfg, out[TRAIN_ARCH][0], masked))
    return out


def _parity(losses, flat, ref):
    """(the worst loss error, the worst parameter error, that leaf), each
    error |port - JAX| / (1 + |JAX|)."""
    want_l, want_p = ref
    loss_err = float(np.max(np.abs(np.array(losses) - want_l) / (1 + np.abs(want_l))))
    errs = {k: float(np.max(np.abs(v - want_p[k]) / (1 + np.abs(want_p[k]))))
            for k, v in flat.items()}
    assert sorted(flat) == sorted(want_p)
    worst = max(errs, key=errs.get)
    return loss_err, errs[worst], worst


def _forbidden(*args, **kw):
    raise AssertionError("a whole-tree gather inside the sharded step")


def _sharded_run(arch, mesh, profile, tree, batches, probe=False):
    """Three sharded steps of ``arch`` on the rank's blocks of ``tree``.
    Returns (losses, the gathered parameters, the optimizer's count, what
    the step showed): whether every gradient reached AdamW in its block's
    shape, the peak of gathered leaves alive against one layer's leaves
    plus the embedding, the head and the final norm; ``probe`` also counts
    the FLOPs of one ``grad_fn`` against one process's on the whole
    batch."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.runtime import steps as steps_mod
    cfg = TC.reduced(TC.get_config(arch))
    step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=mesh,
                            profile=profile)
    params = tree_map(lambda a, s, path: torch.from_numpy(np.array(   # a copy
        sharding.local_shard(a, s, mesh))).requires_grad_(), tree, step.pspecs)
    opt = adamw_init(params)
    shapes_ok = []
    real_update = steps_mod.adamw_update

    def checked_update(grads, state, ps, **kw):
        shapes_ok.append(all(g.shape == p.shape for g, p in zip(
            TP.tree_leaves(grads), TP.tree_leaves(ps))))
        return real_update(grads, state, ps, **kw)

    real_gathers = sharding.gather_full, sharding.tree_gather_full
    steps_mod.adamw_update = checked_update
    sharding.gather_full = sharding.tree_gather_full = _forbidden
    sharding.reset_gather_counts()
    losses, seen = [], {}
    try:
        for b in batches:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        seen["peak_live"] = sharding.peak_live_gathered_bytes
        seen["gathered"] = sharding.gathered_bytes
        if probe:
            tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
            with FlopCounterMode(display=False) as fc:
                step.grad_fn(params, tb)
            mine = fc.get_total_flops()
            whole = tree_map(lambda a, path: torch.from_numpy(a.copy()), tree)
            with FlopCounterMode(display=False) as fc:
                build_grad_fn(cfg)(whole, tb)
            seen["flops"] = (mine, fc.get_total_flops())
    finally:
        steps_mod.adamw_update = real_update
        sharding.gather_full, sharding.tree_gather_full = real_gathers
    seen["shapes_ok"] = bool(shapes_ok) and all(shapes_ok)
    seen["bound"] = _one_layer_and_the_rest(cfg)
    full = sharding.tree_gather_full(params, step.pspecs, mesh)
    return losses, _port_flat(tree_map(lambda t, path: t.detach().numpy(), full)), \
        int(opt.count), seen


def _one_layer_and_the_rest(cfg):
    """Bytes of the largest layer's whole leaves (a stacked leaf's slice)
    plus every leaf outside the blocks (embedding, head, final norms):
    float32, as the reduced configs compute."""
    layers, rest = {}, 0

    def add(d, path):
        nonlocal rest
        parts = path.split(".")
        n = 4 * int(np.prod(d.shape))
        if not parts[0].endswith("blocks"):
            rest += n
        elif d.axes and d.axes[0] == "layers":
            layers[parts[0]] = layers.get(parts[0], 0) + n // d.shape[0]
        else:                                     # a list of blocks
            key = ".".join(parts[:2])
            layers[key] = layers.get(key, 0) + n
    tree_map(add, get_module(cfg).param_defs(cfg))
    return max(layers.values()) + rest


def _family_rank(refs, moe_meshed):
    """One rank of the (2, 2) and (1, 4) worlds: every family under every
    profile on (2, 2), h2o's masked batches on (2, 2), h2o on (1, 4); each
    run's parity with its reference computed here."""
    out = {}
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch in FAMILIES:
        tree, batches, ref = refs[arch]
        for profile in TRAIN_PROFILES:
            want = moe_meshed if arch in MOE_ARCHS and profile != "fsdp" else ref
            losses, flat, count, seen = _sharded_run(arch, mesh, profile, tree, batches,
                                                     probe=arch == TRAIN_ARCH)
            out[(arch, profile, (2, 2))] = (_parity(losses, flat, want), count, seen)
    tree, batches, ref = refs["masked"]
    losses, flat, count, seen = _sharded_run(TRAIN_ARCH, mesh, "2d", tree, batches)
    out[("masked", "2d", (2, 2))] = (_parity(losses, flat, ref), count, seen)
    mesh = mesh_lib.make_mesh((1, 4), ("data", "model"), device="cpu")
    tree, batches, ref = refs[TRAIN_ARCH]
    for profile in ("2d", "tp"):
        losses, flat, count, seen = _sharded_run(TRAIN_ARCH, mesh, profile, tree, batches)
        out[(TRAIN_ARCH, profile, (1, 4))] = (_parity(losses, flat, ref), count, seen)
    return out


def _pairs_of(mesh):
    """Megatron's conjugate pairs on (1, 2), by rank r = 0, 1: forward values
    and the gradients each rank gets."""
    from repro_torch.runtime import collectives as C
    r = mesh.coords["model"]
    x = torch.tensor([1.0 + r, 3.0 - r], requires_grad=True)
    out = {"copy": C.copy_to(x, mesh, "model").detach().numpy(),
           "reduce": C.reduce_from(x, mesh, "model").detach().numpy(),
           "gather": C.gather_from(x, mesh, "model", 0).detach().numpy(),
           "max": C.pmax(x, mesh, "model").numpy()}
    w = torch.tensor([10.0 + r, 20.0])
    for name, fn in (("copy", C.copy_to), ("reduce", C.reduce_from)):
        (g,) = torch.autograd.grad((fn(x, mesh, "model") * w).sum(), x)
        out["d" + name] = g.numpy()
    (g,) = torch.autograd.grad((C.gather_from(x, mesh, "model", 0)
                                * torch.arange(4.0)).sum(), x)
    out["dgather"] = g.numpy()
    return r, out


def _pair_rank(refs):
    """One rank of the two-rank world: Megatron's pairs, h2o on (1, 2)
    under 'tp' (with the FLOP count) and its masked batches on (2, 1)."""
    out = {"pairs": _pairs_of(mesh_lib.make_mesh((1, 2), ("data", "model"),
                                                  device="cpu"))}
    tree, batches, ref = refs[TRAIN_ARCH]
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    losses, flat, count, seen = _sharded_run(TRAIN_ARCH, mesh, "tp", tree, batches, probe=True)
    out["tp12"] = (_parity(losses, flat, ref), count, seen)
    tree, batches, ref = refs["masked"]
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), device="cpu")
    losses, flat, count, seen = _sharded_run(TRAIN_ARCH, mesh, "2d", tree, batches)
    out["masked21"] = (_parity(losses, flat, ref), count, seen)
    return out


@pytest.fixture(scope="module")
def family_worlds(jax_train, forced):
    """The (2, 2) / (1, 4) world of four ranks and the two-rank world, each
    spawned once for the module; every rank's results."""
    out, _ = forced
    refs = {k: (v[0], v[1], v[2]) for k, v in jax_train.items()}
    moe_meshed = ([float(x) for x in out["moestep/losses"]],
                  {k[len("moestep/p/"):]: v for k, v in out.items()
                   if k.startswith("moestep/p/")})
    four = mesh_lib.spawn_local(4, _family_rank, refs, moe_meshed, device="cpu",
                                timeout_s=4 * WORLD_S)
    two = _spawn(2, _pair_rank, refs)
    return four, two


def _held(result, what):
    (loss_err, param_err, worst), count, seen = result
    assert count == 3, what
    assert loss_err <= PARITY, f"{what}: loss error {loss_err:.3e}"
    assert param_err <= PARITY, f"{what}: {worst} error {param_err:.3e}"
    assert seen["shapes_ok"], f"{what}: a gradient reached AdamW in another shape"
    assert seen["peak_live"] <= seen["bound"], (what, seen)


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_on_a_2x2_world_holds_the_unsharded_reference(family_worlds, arch):
    """Each family's reduced config on (data 2, model 2) under '2d', 'tp'
    and 'fsdp', three steps of 4 x 32 on every rank: the losses and every
    parameter within 2e-4 (1 + |b|) of JAX's unsharded step (module
    docstring), where the MoE under '2d' / 'tp' is held to JAX's step with
    its (2, 2) mesh installed (forced host devices), whose shard_map MoE
    routes each data shard with its own capacity as the port's does; every
    gradient in its block's shape at AdamW, no whole-tree gather, and the
    gathered leaves alive at once never more than one layer's plus the
    embedding, the head and the final norm."""
    four, _ = family_worlds
    for r, rank in enumerate(four):
        for profile in TRAIN_PROFILES:
            result = rank[(arch, profile, (2, 2))]
            _held(result, f"{arch} {profile} rank {r}")
            # 'tp' keeps the weights replicated over 'data': nothing to gather
            assert (result[2]["gathered"] > 0) == (profile != "tp"), (arch, profile)


def test_sharded_train_step_equals_the_unsharded_reference(family_worlds):
    """h2o-danube-1.8b reduced (heads 4, kv 2) on a (2, 2) world under '2d',
    'tp' and 'fsdp', and on (1, 4) under '2d' and 'tp', where the KV heads
    are replicated and each rank reads the one of its query head: three
    steps of 4 x 32, the losses and every parameter within 2e-4 (1 + |b|)
    of JAX's unsharded step (module docstring: the reference's own sharded
    step fails on the CPU)."""
    four, _ = family_worlds
    for r, rank in enumerate(four):
        for profile in TRAIN_PROFILES:
            _held(rank[(TRAIN_ARCH, profile, (2, 2))], f"(2, 2) {profile} rank {r}")
        for profile in ("2d", "tp"):
            _held(rank[(TRAIN_ARCH, profile, (1, 4))], f"(1, 4) {profile} rank {r}")


def test_a_loss_mask_under_data_parallelism_holds_the_masked_reference(family_worlds):
    """h2o's batches with a seeded loss_mask on (2, 1) and (2, 2): the global
    masked mean, each rank's masked sum over the mask's count summed over
    the dp axes, within 2e-4 (1 + |b|) of JAX's unsharded masked step."""
    four, two = family_worlds
    for r, rank in enumerate(four):
        _held(rank[("masked", "2d", (2, 2))], f"masked (2, 2) rank {r}")
    for r, rank in enumerate(two):
        _held(rank["masked21"], f"masked (2, 1) rank {r}")


def test_the_conjugate_pairs_forward_and_backward(family_worlds):
    """On (1, 2): ``copy_to`` is the identity whose gradient is the sum of
    the ranks' (w0 + w1), ``reduce_from`` the sum whose gradient is the
    rank's own, ``gather_from`` the concatenation whose gradient is the
    rank's slice of the cotangent, ``pmax`` the elementwise max."""
    _, two = family_worlds
    xs = {0: np.array([1.0, 3.0]), 1: np.array([2.0, 2.0])}
    ws = {0: np.array([10.0, 20.0]), 1: np.array([11.0, 20.0])}
    for r, got in (rank["pairs"] for rank in two):
        np.testing.assert_array_equal(got["copy"], xs[r])
        np.testing.assert_array_equal(got["reduce"], xs[0] + xs[1])
        np.testing.assert_array_equal(got["gather"], np.concatenate([xs[0], xs[1]]))
        np.testing.assert_array_equal(got["max"], np.maximum(xs[0], xs[1]))
        np.testing.assert_array_equal(got["dcopy"], ws[0] + ws[1])
        np.testing.assert_array_equal(got["dreduce"], ws[r])
        np.testing.assert_array_equal(got["dgather"], np.arange(4.0)[2 * r:2 * r + 2])


def test_a_rank_computes_its_share_of_the_flops(family_worlds):
    """``FlopCounterMode`` over one ``grad_fn`` of h2o reduced: each rank's
    count at most 0.55 of one process's on the whole batch on (1, 2) under
    'tp', and at most 0.30 of it on (2, 2) under '2d'."""
    four, two = family_worlds
    for rank in two:
        _held(rank["tp12"], "tp (1, 2)")
        mine, whole = rank["tp12"][2]["flops"]
        assert 0 < mine <= 0.55 * whole, (mine, whole)
    for rank in four:
        mine, whole = rank[(TRAIN_ARCH, "2d", (2, 2))][2]["flops"]
        assert 0 < mine <= 0.30 * whole, (mine, whole)


def _one_by_one_rank(tree, batches):
    cfg = TC.reduced(TC.get_config(TRAIN_ARCH))
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cpu")
    runs = {}
    for name, m in (("mesh", mesh), ("none", None)):
        step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=m)
        params = tree_map(lambda a, path: torch.from_numpy(a.copy()).requires_grad_(), tree)
        opt = adamw_init(params)
        metrics = []
        for b in batches:
            params, opt, mt = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append([mt[k].item() for k in ("loss", "ce", "aux", "grad_norm")])
        runs[name] = (metrics, TP.tree_leaves(params), TP.tree_leaves(opt.m),
                      TP.tree_leaves(opt.v))
    a, b = runs["mesh"], runs["none"]
    return a[0] == b[0] and all(torch.equal(x, y) for part in (1, 2, 3)
                                for x, y in zip(a[part], b[part]))


def test_one_by_one_mesh_changes_no_bit():
    """A (1, 1) mesh in a world of one rank gives the no-mesh step bit for
    bit: metrics, parameters and both moments over three steps."""
    cfg = TC.reduced(TC.get_config(TRAIN_ARCH))
    ds = j_make_dataset(jreduced(jget(TRAIN_ARCH)), dataclasses.replace(
        SHAPES_BY_NAME["train_4k"], seq_len=24, global_batch=2), seed=3)
    tree = init_params(1, get_module(cfg).param_defs(cfg))
    assert _spawn(1, _one_by_one_rank, tree, [ds.batch(s) for s in range(3)]) == [True]


def test_launcher_on_a_mesh_resumes_across_meshes_and_changes_no_value(tmp_path):
    """``launch.train --mesh 2x1`` on two ranks, checkpointed after step 2
    (its final checkpoint taken away), then resumed on a (1, 2) mesh for
    the third step (``restore_sharded`` of rank 0's checkpoint): the final
    checkpoint equals a one-device run of 3 steps within 2e-5 (sums in
    another order, no other difference)."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    common = ["--arch", "olmo-1b", "--reduced", "--batch", "4", "--seq", "16",
              "--device", "cpu", "--warmup", "1", "--steps", "3"]
    one, two = tmp_path / "one", tmp_path / "two"
    train.main(common + ["--ckpt-dir", str(one)])
    _spawn(2, train.main, common + ["--ckpt-dir", str(two), "--ckpt-every", "2",
                                    "--mesh", "2x1"])
    shutil.rmtree(two / "step_00000003")
    _spawn(2, train.main, common + ["--ckpt-dir", str(two), "--mesh", "1x2"])
    _, want = load_checkpoint(one, 3)
    _, got = load_checkpoint(two, 3)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the compressed pod all-reduce
# ---------------------------------------------------------------------------


def _pod_rank(grads, fb):
    mesh = mesh_lib.make_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    spec = {k: P("pod", *([None] * (v.ndim - 1))) for k, v in grads.items()}
    blk = lambda t: {k: torch.from_numpy(np.ascontiguousarray(                 # noqa: E731
        sharding.local_shard(v, spec[k], mesh))) for k, v in t.items()}
    mean, new_fb = compressed_pod_allreduce(blk(grads), blk(fb), mesh)
    return mesh.coords["pod"], {k: v.numpy() for k, v in mean.items()}, \
        {k: v.numpy() for k, v in new_fb.items()}


def test_compressed_pod_allreduce_equals_the_reference(forced):
    """On a pod = 2 world: the means and the new feedback of every leaf
    within 1e-6 of the reference's on a forced 2-device ("pod",) mesh."""
    out, _ = forced
    grads, fb = _pod_inputs()
    ranks = sorted(_spawn(2, _pod_rank, grads, fb), key=lambda r: r[0])
    for k in grads:
        np.testing.assert_allclose(np.concatenate([r[1][k] for r in ranks]),
                                   out[f"pod/mean/{k}"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.concatenate([r[2][k] for r in ranks]),
                                   out[f"pod/fb/{k}"], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


def _restore_rank(ckpt_dir):
    cfg = TC.reduced(TC.get_config("olmo-1b"))
    defs = get_module(cfg).param_defs(cfg)
    full = {"params": init_params(0, defs)}
    checked = 0
    for shape in ((2, 2), (4, 1)):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), device="cpu")
        specs = sharding.model_param_pspecs(cfg, mesh, defs)
        like = {"params": tree_map(lambda d, path: torch.empty(0), defs)}
        step, got = restore_sharded(ckpt_dir, like, {"params": specs}, mesh)
        assert step == 5

        def check(t, a, s, path):
            nonlocal checked
            want = np.ascontiguousarray(sharding.local_shard(a, s, mesh))
            assert t.shape == want.shape and np.array_equal(t.numpy(), want), path
            checked += 1
        tree_map(check, got["params"], full["params"], specs)
    return checked


def test_restore_sharded_across_meshes(tmp_path):
    """olmo-1b reduced, written by one process, restored onto (2, 2) and
    (4, 1): every rank's block of every leaf equals its slice bit for bit
    (the port of ``tests/test_elastic_restore.py``)."""
    cfg = TC.reduced(TC.get_config("olmo-1b"))
    save_checkpoint(tmp_path, 5, {"params": init_params(0, get_module(cfg).param_defs(cfg))})
    n_leaves = len(TP.tree_leaves(get_module(cfg).param_defs(cfg)))
    assert _spawn(4, _restore_rank, str(tmp_path)) == [2 * n_leaves] * 4


# ---------------------------------------------------------------------------
# routing and guards
# ---------------------------------------------------------------------------


def test_actshard_is_a_no_op_without_a_mesh():
    actshard.set_mesh(None)
    x = torch.randn(4, 8)
    assert actshard.batch_sharded(x) is x
    assert actshard.attn_out_sharded(x) is x and actshard.logits_sharded(x) is x
    assert actshard.current_mesh() is None and actshard.current_profile() == "2d"


def test_moe_apply_auto_picks_the_sharded_form_as_the_reference(monkeypatch):
    """The sharded MoE under '2d' / 'tp' with a 'model' axis that divides
    the padded experts; the plain one without a mesh, under 'fsdp', or
    where 'model' does not divide them."""
    cfg = TC.reduced(TC.get_config("qwen2-moe-a2.7b"))
    monkeypatch.setattr(moe_sharded, "moe_apply_sharded", lambda *a, **k: "sharded")
    monkeypatch.setattr(L, "moe_apply", lambda *a, **k: "plain")
    cases = [(None, "2d", "plain"), ((1, 4), "2d", "sharded"), ((2, 2), "tp", "sharded"),
             ((1, 4), "fsdp", "plain"), ((1, 4), "cp", "plain"), ((1, 3), "2d", "plain")]
    try:
        for shape, profile, want in cases:
            actshard.set_mesh(None if shape is None else
                              mesh_lib.abstract_mesh(shape, ("data", "model")), profile)
            assert L.moe_apply_auto(cfg, {}, torch.zeros(2, 64)) == want, (shape, profile)
        actshard.set_mesh(mesh_lib.abstract_mesh((4,), ("data",)))
        assert L.moe_apply_auto(cfg, {}, torch.zeros(2, 64)) == "plain"
    finally:
        actshard.set_mesh(None)


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


def test_backend_follows_the_layout_and_refuses_nccl_on_a_shared_card():
    assert mesh_lib.pick_backend(4, "cpu")[0] == "gloo"
    assert mesh_lib.pick_backend(2, "cuda", cards=1)[0] == "gloo"
    assert mesh_lib.pick_backend(1, "cuda", cards=1)[0] == "nccl"
    assert mesh_lib.pick_backend(4, "cuda", cards=8)[0] == "nccl"
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.pick_backend(2, "cuda", "nccl", cards=1)
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.pick_backend(2, "cpu", "nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.pick_backend(2, "cuda", cards=0)


def _fails(rank_to_fail):
    import torch.distributed as dist
    if dist.get_rank() == rank_to_fail:
        raise ValueError("this rank fails")
    dist.barrier()


def _hangs():
    import time
    time.sleep(60)


def test_a_failed_rank_or_a_world_past_its_limit_fails_the_spawn():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh_lib.spawn_local(2, _fails, 1, device="cpu", timeout_s=60)
    with pytest.raises(RuntimeError, match="outlived its limit"):
        mesh_lib.spawn_local(2, _hangs, device="cpu", timeout_s=3)


def test_a_world_of_one_from_the_environment_leaves_no_files(tmp_path):
    """``init_from_env`` with no launcher's environment: a world of one
    rank on an in-memory store, whose (1, 1) mesh's collectives return
    their input, and nothing left in the temporary directory."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.runtime import collectives
        assert mesh_lib.init_from_env("cpu") == "gloo"
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cpu")
        x = torch.arange(6.0)
        assert torch.equal(collectives.mesh_mean(x, mesh), x)
        print("ok")
        """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR")}
    env.update(TMPDIR=str(tmp_path), PYTHONPATH=str(Path(__file__).parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    assert list(tmp_path.iterdir()) == []
