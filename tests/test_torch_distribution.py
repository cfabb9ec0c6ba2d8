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
changes no value, so a mesh must change none either.
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
from repro_torch.runtime import build_train_step, sharding
from repro_torch.runtime.collectives import mesh_mean

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
    ``compressed_pod_allreduce`` on a 2-device ("pod",) mesh."""
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
            lambda p, path: mesh_mean(next(it), mesh).numpy(), params))
    return res


def test_sharded_moe_equals_the_plain_layer_on_1x4():
    """On (data 1, model 4) each rank runs one of the 4 padded experts: the
    output equals JAX's plain ``moe_apply`` within 3e-4 and the aux within
    1e-4 relative (the capacity is the global one), and the mean of the
    ranks' gradients equals autograd of the port's plain ``moe_apply``
    within 3e-4, both reduced MoE configs."""
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


def _train_rank(shape, profiles, tree, batches):
    cfg = TC.reduced(TC.get_config(TRAIN_ARCH))
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for profile in profiles:
        step = build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10),
                                mesh=mesh, profile=profile)
        params = tree_map(lambda a, s, path: torch.from_numpy(np.array(   # a copy
            sharding.local_shard(a, s, mesh))).requires_grad_(), tree, step.pspecs)
        opt = adamw_init(params)
        losses = []
        for b in batches:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        full = sharding.tree_gather_full(params, step.pspecs, mesh)
        out[profile] = dict(losses=losses, params=_port_flat(tree_map(
            lambda t, path: t.detach().numpy(), full)), count=int(opt.count))
    return out


def test_sharded_train_step_equals_the_unsharded_reference():
    """h2o-danube-1.8b reduced on a (2, 2) world, profiles '2d' and 'fsdp',
    three steps of 4 x 32: the loss of each step and every parameter after
    them within 2e-4 (1 + |b|) of JAX's unsharded step (module docstring:
    the reference's own sharded step fails on the CPU)."""
    jcfg = jreduced(jget(TRAIN_ARCH))
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], seq_len=32, global_batch=4)
    ds = j_make_dataset(jcfg, shape, seed=11)
    batches = [ds.batch(s) for s in range(3)]
    tree = _np_tree(jax.jit(lambda k: JP.init_params(
        k, j_get_module(jcfg).param_defs(jcfg)))(jax.random.PRNGKey(0)))
    jp, jopt = jax.tree.map(jnp.asarray, tree), None
    jopt = j_adamw_init(jp)
    jstep = jax.jit(j_build_train_step(jcfg, lr_schedule=j_warmup_cosine(1e-3, 2, 10)))
    jloss = []
    for b in batches:
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        jloss.append(float(jm["loss"]))
    want = _jax_flat(jp)
    ranks = _spawn(4, _train_rank, (2, 2), ("2d", "fsdp"), tree, batches)
    for r in ranks:
        for profile in ("2d", "fsdp"):
            got = r[profile]
            assert got["count"] == 3
            np.testing.assert_allclose(got["losses"], jloss, rtol=2e-4, atol=2e-4)
            assert sorted(got["params"]) == sorted(want)
            for k, v in got["params"].items():
                np.testing.assert_allclose(v, np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                           err_msg=f"{profile} {k}")


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


def test_cp_profile_raises_and_names_its_item():
    cfg = TC.reduced(TC.get_config(TRAIN_ARCH))
    mesh = mesh_lib.abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 2, 10), mesh=mesh,
                         profile="cp")


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
