"""Serving under a mesh against the JAX package's, on the CPU.

The port's sharded prefill and decode steps (``runtime.build_prefill_step``
/ ``build_decode_step`` with ``mesh=``) run as each rank's program in
worlds of gloo processes (``launch.mesh.spawn_local``, each world with its
own time limit), in the reference dry-run's serving layout: the
parameters by ``model_param_pspecs``, the prompt by ``batch_pspecs``, the
cache by ``cache_pspecs``.  They are held to the JAX package's UNSHARDED
jitted ``build_prefill_step`` / ``build_decode_step`` on the same numpy
weights and prompts: GSPMD changes no value, so the reference's sharded
serving gives the unsharded numbers, and a mesh must change none either.
The one exception is the MoE under '2d' / 'tp' with two data shards, whose
``moe_apply_sharded`` routes each shard with its own capacity: there it is
held to JAX's steps with its (2, 2) mesh installed (``actshard.set_mesh``
on forced host devices, one subprocess), which run that layer under
``shard_map``.  Decode is teacher-forced on JAX's tokens; the port's own
greedy tokens must equal JAX's.

Under 'cp' the prompt's sequence is split over 'model' (the
encoder-decoder's frames, its one-token decoder prefix whole): each rank
prefills its positions, the ring of a banded prefill is built from the
ranks that hold its positions, and the states the sequence leaves are the
last rank's, moved into the cache's blocks.  Every family is held to
JAX's unsharded steps (the MoE routes the global batch in the reference's
token order, so its capacity is the unsharded one).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES_BY_NAME
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.launch.specs import cache_specs as j_cache_specs
from repro.launch.specs import input_specs as j_input_specs
from repro.models import get_module as j_get_module
from repro.models import params as JP
from repro.runtime import build_decode_step as j_build_decode_step
from repro.runtime import build_prefill_step as j_build_prefill_step
from repro_torch import configs as TC
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as tserve
from repro_torch.launch.specs import cache_specs, input_specs
from repro_torch.models import actshard, get_module
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import image_text_positions
from repro_torch.models.params import PartitionSpec as P
from repro_torch.models.params import from_jax_params
from repro_torch.runtime import build_decode_step, build_prefill_step, sharding
from repro_torch.runtime.steps import greedy_token, prefill_cache_struct

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=8")
WORLD_S = 240           # each spawned world's time limit
# one reduced config a family: dense, tied head (olmo's non-parametric norm),
# VLM (M-RoPE, inputs_embeds), MoE, encoder-decoder, RWKV-6, RecurrentGemma
FAMILIES = ("h2o-danube-1.8b", "olmo-1b", "qwen2-vl-2b", "qwen2-moe-a2.7b",
            "seamless-m4t-large-v2", "rwkv6-1.6b", "recurrentgemma-2b")
PROFILES = ("2d", "tp", "fsdp")
CP = "cp"
MOE = "qwen2-moe-a2.7b"
DENSE = "h2o-danube-1.8b"
HYBRID = "recurrentgemma-2b"
AUDIO = "seamless-m4t-large-v2"
EDGE = {"window8": 8, "prompt31": None, "window24": 24}   # h2o's window a case
PARITY = 2e-4           # |port - JAX| <= PARITY (1 + |JAX|)
# the cache fields a recurrence's prefill leaves at the sequence's end
LEFT = ("state", "shift_tm", "shift_cm", "rec_h", "conv_state")
B, S, GEN = 4, 32, 8    # prompt rows and length, decode steps


# ---------------------------------------------------------------------------
# the reference's unsharded serving, once for the module
# ---------------------------------------------------------------------------


def _prompt(cfg, rows: int, length: int) -> dict:
    """A seeded prompt batch (numpy): tokens; the VLM's ``inputs_embeds``
    and three M-RoPE position streams; the encoder-decoder's frames and
    one-token decoder prefix."""
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, length)).astype(np.int32)}
    if cfg.embedding_inputs:
        batch["inputs_embeds"] = rng.standard_normal(
            (rows, length, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["tokens"] = np.ascontiguousarray(batch["tokens"][:, :1])
    elif cfg.embedding_inputs:
        del batch["tokens"]
    if cfg.rope == "mrope":
        batch["positions"] = image_text_positions(rows, length, 4).numpy()
    return batch


def _decode_len(cfg, length: int):
    return length + GEN if cfg.family == "audio" else None


def _np_cache(cache) -> dict:
    """A cache NamedTuple -> {field: array or list of arrays} (float32)."""
    out = {}
    for f in cache._fields:
        v = getattr(cache, f)
        conv = lambda a: np.asarray(a, np.float32) if hasattr(a, "dtype") \
            and np.asarray(a).dtype != np.int32 else np.asarray(a)   # noqa: E731
        out[f] = [conv(a) for a in v] if isinstance(v, (list, tuple)) else conv(v)
    return out


def _jax_serve(jcfg, tree, batch) -> dict:
    """JAX's unsharded prefill, then GEN greedy decode steps from token 0:
    the last hidden, the caches after the prefill and at the end, and each
    step's input token, logits and token."""
    jp = jax.tree.map(jnp.asarray, tree)
    dlen = _decode_len(jcfg, batch[next(iter(batch))].shape[1])
    last, cache = jax.jit(j_build_prefill_step(jcfg, decode_len=dlen))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"last": np.asarray(last), "prefill_cache": _np_cache(cache)}
    decode = jax.jit(j_build_decode_step(jcfg))
    tok = jnp.zeros((batch[next(iter(batch))].shape[0], 1), jnp.int32)
    out["inputs"], out["logits"], out["tokens"] = [], [], []
    for _ in range(GEN):
        t, lg, cache = decode(jp, cache, {"tokens": tok})
        out["inputs"].append(np.asarray(tok))
        out["logits"].append(np.asarray(lg))
        out["tokens"].append(np.asarray(t))
        tok = t[:, None]
    out["cache"] = _np_cache(cache)
    return out


def _jax_tree(jcfg):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        lambda k: JP.init_params(k, j_get_module(jcfg).param_defs(jcfg)))(
            jax.random.PRNGKey(0)))


def _edge_cfgs():
    """(name, JAX config, prompt length) of the (1, 2) edge cases: h2o with
    an 8-slot window (a banded prefill into a ring whose writes wrap across
    both ranks' slots), and a prompt of 31, which 'model' does not divide
    (the cache stays whole); for 'cp' also h2o with a 24-slot window (the
    ring's positions 8 ... 31 held by both ranks of a 32-token prompt) and
    RecurrentGemma on a 1 x 4 prompt (2 positions a rank: the
    convolution's 3 inputs from before a rank's block come from more than
    one rank)."""
    j = jreduced(jget(DENSE))
    return (("window8", dataclasses.replace(j, window=8), S),
            ("prompt31", j, S - 1),
            ("window24", dataclasses.replace(j, window=24), S),
            ("rg1x4", jreduced(jget(HYBRID)), 4))


_MESHED_MOE = f"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.models import actshard, get_module, params as PL
from repro.runtime import build_decode_step, build_prefill_step
inp = dict(np.load(sys.argv[1]))
cfg = reduced(get_config({MOE!r}))
p = jax.jit(lambda k: PL.init_params(k, get_module(cfg).param_defs(cfg)))(
    jax.random.PRNGKey(0))
out = {{}}
for prof in ("2d", "tp"):
    actshard.set_mesh(jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                      axis_types=(jax.sharding.AxisType.Auto,) * 2), prof)
    last, cache = jax.jit(build_prefill_step(cfg))(p, {{"tokens": jnp.asarray(inp["tokens"])}})
    out[prof + "/last"] = np.asarray(last)
    for f in ("k", "v"):
        out[prof + "/prefill_cache/" + f] = np.asarray(getattr(cache, f), np.float32)
    dec = jax.jit(build_decode_step(cfg))
    tok = jnp.zeros(({B}, 1), jnp.int32)
    for s in range({GEN}):
        t, lg, cache = dec(p, cache, {{"tokens": tok}})
        out[prof + "/inputs/" + str(s)] = np.asarray(tok)
        out[prof + "/logits/" + str(s)] = np.asarray(lg)
        out[prof + "/tokens/" + str(s)] = np.asarray(t)
        tok = t[:, None]
    for f in ("k", "v"):
        out[prof + "/cache/" + f] = np.asarray(getattr(cache, f), np.float32)
    out[prof + "/cache/step"] = np.asarray(cache.step)
    out[prof + "/prefill_cache/step"] = np.asarray({S})
    actshard.set_mesh(None)
np.savez(sys.argv[2], **out)
print("meshed OK", jax.device_count())
"""


def _meshed_refs(d: Path) -> dict:
    """{profile: refs} of the MoE family: JAX's prefill and decode steps
    with its (2, 2) mesh installed on forced host devices ('2d' and
    'tp')."""
    out = dict(np.load(d / "moe_out.npz"))
    refs = {}
    for prof in ("2d", "tp"):
        steps = range(GEN)
        refs[prof] = {
            "last": out[f"{prof}/last"],
            "prefill_cache": {f: out[f"{prof}/prefill_cache/{f}"] for f in ("k", "v", "step")},
            "cache": {f: out[f"{prof}/cache/{f}"] for f in ("k", "v", "step")},
            "inputs": [out[f"{prof}/inputs/{s}"] for s in steps],
            "logits": [out[f"{prof}/logits/{s}"] for s in steps],
            "tokens": [out[f"{prof}/tokens/{s}"] for s in steps]}
    return refs


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    """Each family's tree, prompt and JAX's unsharded serving; the (1, 2)
    edge cases' under their names; the MoE's meshed serving under
    ("meshed", profile), from a subprocess started first and read last."""
    d = tmp_path_factory.mktemp("serve_mesh")
    moe_batch = _prompt(jreduced(jget(MOE)), B, S)
    np.savez(d / "moe_in.npz", tokens=moe_batch["tokens"])
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_MESHED_MOE),
                             str(d / "moe_in.npz"), str(d / "moe_out.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=ENV, cwd=ROOT)
    out = {}
    for arch in FAMILIES:
        jcfg = jreduced(jget(arch))
        tree, batch = _jax_tree(jcfg), _prompt(jcfg, B, S)
        out[arch] = (arch, tree, batch, _jax_serve(jcfg, tree, batch))
    for name, jcfg, length in _edge_cfgs():
        arch = DENSE if name in EDGE else HYBRID
        tree = out[arch][1]
        batch = _prompt(jcfg, 1 if name == "rg1x4" else B, length)
        out[name] = (arch, tree, batch, _jax_serve(jcfg, tree, batch))
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "meshed OK 8" in stdout, stderr[-3000:]
    meshed = _meshed_refs(d)
    for prof in ("2d", "tp"):
        out[("meshed", prof)] = (MOE, out[MOE][1], out[MOE][2], meshed[prof])
    return out


# ---------------------------------------------------------------------------
# one rank's serving
# ---------------------------------------------------------------------------


def _port_cfg(case: str):
    if case == "rg1x4":
        return TC.reduced(TC.get_config(HYBRID))
    cfg = TC.reduced(TC.get_config(DENSE if case in EDGE else case))
    return dataclasses.replace(cfg, window=EDGE[case]) if EDGE.get(case) else cfg


def _err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / (1 + |want|), infinities equal where both are."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    same = np.isinf(want) & (got == want)
    d = np.where(same, 0.0, np.abs(got - want) / (1 + np.abs(np.where(same, 0, want))))
    return float(d.max()) if d.size else 0.0


def _cache_err(cache, specs, want: dict, mesh) -> float:
    worst = 0.0
    for f in cache._fields:
        got, spec = getattr(cache, f), getattr(specs, f)
        if isinstance(got, list):
            for g, s, w in zip(got, spec, want[f]):
                worst = max(worst, _err(sharding.gather_full(g, s, mesh).numpy(), w))
        else:
            worst = max(worst, _err(sharding.gather_full(got, spec, mesh).float().numpy(),
                                    want[f]))
    return worst


def _shapes_ok(cache, specs, struct, mesh) -> bool:
    """Each leaf of the rank's cache has exactly the shape ``local_shard``
    gives it under ``cache_pspecs``."""
    for f in cache._fields:
        got, spec, whole = getattr(cache, f), getattr(specs, f), getattr(struct, f)
        pairs = (zip(got, spec, whole) if isinstance(got, list)
                 else [(got, spec, whole)])
        for g, s, w in pairs:
            want = sharding.local_shard(torch.empty(w.shape, device="meta"), s, mesh).shape
            if tuple(g.shape) != tuple(want):
                return False
    return True


def _serve_rank(case: str, ref, mesh, profile: str) -> dict:
    """The sharded prefill and GEN teacher-forced decode steps of ``case``
    on this rank, each output gathered and held to ``ref`` here: the worst
    errors of the last hidden, the caches and the logits, whether the
    greedy tokens equal JAX's and the cache blocks have their shapes."""
    _, tree, batch, want = ref
    cfg = _port_cfg(case)
    defs = get_module(cfg).param_defs(cfg)
    pspecs = sharding.model_param_pspecs(cfg, mesh, defs, profile=profile)
    params = sharding.tree_local_shard(from_jax_params(tree, device="cpu"), pspecs, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dlen = _decode_len(cfg, tb[next(iter(tb))].shape[1])
    struct = prefill_cache_struct(cfg, tb, dlen)
    specs = sharding.cache_pspecs(cfg, mesh, struct, profile)
    rows = sharding.batch_pspecs(cfg, mesh, tb, profile)[next(iter(tb))][0]
    prefill = build_prefill_step(cfg, decode_len=dlen, mesh=mesh, profile=profile)
    decode = build_decode_step(cfg, mesh=mesh, profile=profile, cache_struct=struct)
    res = {}
    with torch.inference_mode():
        last, cache = prefill(params, tb)
        prefill_cache = cache
        res["last"] = _err(sharding.gather_full(last, P(rows, None), mesh).numpy(),
                           want["last"])
        res["prefill_cache"] = _cache_err(cache, specs, want["prefill_cache"], mesh)
        res["shapes_ok"] = _shapes_ok(cache, specs, struct, mesh)
        res["logits"], res["tokens_equal"] = 0.0, True
        vocab = P(rows, "model" if profile != "fsdp" else None)
        for tok, lg_want, t_want in zip(want["inputs"], want["logits"], want["tokens"]):
            t, lg, cache = decode(params, cache, {"tokens": torch.from_numpy(tok)})
            res["logits"] = max(res["logits"], _err(
                sharding.gather_full(lg, vocab, mesh).numpy(), lg_want))
            res["tokens_equal"] &= bool(np.array_equal(
                sharding.gather_full(t, P(rows), mesh).numpy(), t_want))
        res["cache"] = _cache_err(cache, specs, want["cache"], mesh)
        res["shapes_ok"] &= _shapes_ok(cache, specs, struct, mesh)
        if profile == CP:                 # what the sequence leaves, gathered
            res["left"] = [last.numpy()]
            for f in LEFT:
                if f not in prefill_cache._fields:
                    continue
                got, spec = getattr(prefill_cache, f), getattr(specs, f)
                pairs = zip(got, spec) if isinstance(got, list) else [(got, spec)]
                res["left"] += [sharding.gather_full(g, sp, mesh).float().numpy()
                                for g, sp in pairs]
    return res


def _four_rank(refs: dict) -> dict:
    """One rank of the (2, 2) world: every family under every profile (the
    MoE under '2d' / 'tp' against JAX's meshed steps)."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in FAMILIES:
        for profile in PROFILES + (CP,):
            meshed = arch == MOE and profile in ("2d", "tp")
            ref = refs[("meshed", profile)] if meshed else refs[arch]
            out[(arch, profile)] = _serve_rank(arch, ref, mesh, profile)
    return out


# ---------------------------------------------------------------------------
# the (1, 2) world's other cases
# ---------------------------------------------------------------------------


def _tie_case(mesh) -> dict:
    """``greedy_token`` on the rank's half of [3, 256] logits of a config
    whose vocabulary (250) leaves 6 padded entries on rank 1: row 0's
    maximum on both ranks (global 5 and 200), row 1's twice on rank 1 (150
    and 180), row 2's in the padding (masked: global 40 wins)."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config(DENSE)), vocab_size=250)
    whole = torch.zeros(3, cfg.padded_vocab)
    whole[0, 5] = whole[0, 200] = 3.0
    whole[1, 150] = whole[1, 180] = 2.0
    whole[2, 252], whole[2, 40] = 9.0, 1.0
    layout = sharding.Layout(cfg, mesh, get_module(cfg).param_defs(cfg), "tp")
    r = mesh.coords["model"]
    actshard.set_mesh(mesh, "tp", layout)
    try:
        _, tok = greedy_token(cfg, whole[:, r * 128:(r + 1) * 128].clone())
    finally:
        actshard.set_mesh(None)
    _, plain = greedy_token(cfg, whole.clone())
    return {"token": tok.tolist(), "plain": plain.tolist()}


def _partials(rows: int = 2):
    """q [2,4,1,16] and a 12-slot cache [2,2,12,16] (GQA 2), seeded."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(rows, 4, 1, 16, generator=g)
    k = torch.randn(rows, 2, 12, 16, generator=g)
    v = torch.randn(rows, 2, 12, 16, generator=g)
    return q, k, v


def _merge_case(mesh) -> dict:
    """This rank's half of the 12 slots, 5 of them valid (rank 1's block
    all masked): the merge over 'model' against ``decode_attention`` over
    the whole cache."""
    q, k, v = _partials()
    r = mesh.coords["model"]
    slots = torch.arange(6 * r, 6 * r + 6)
    part = attn_lib.decode_attention_partial(q, k[:, :, 6 * r:6 * r + 6],
                                             v[:, :, 6 * r:6 * r + 6], slots,
                                             torch.tensor(5))
    got = attn_lib.merge_partials([part], mesh, "model")
    want = attn_lib.decode_attention(q, k, v, torch.tensor(5))
    return {"err": float((got - want).abs().max()), "l": float(part[2].max()),
            "m": float(part[1].max())}


def _one_one(refs) -> dict:
    """A (1, 1) mesh (no process group: every collective over an axis of
    one rank is its input) serves the dense model with the same bits as
    no mesh."""
    _, tree, batch, want = refs[DENSE]
    mesh = mesh_lib.Mesh((1, 1), ("data", "model"), coords={"data": 0, "model": 0},
                         device="cpu", backend="gloo")
    cfg = _port_cfg(DENSE)
    params = from_jax_params(tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    struct = prefill_cache_struct(cfg, tb)
    outs = []
    with torch.inference_mode():
        for m in (None, mesh):
            kw = {} if m is None else {"mesh": m, "profile": "2d"}
            last, cache = build_prefill_step(cfg, **kw)(params, tb)
            dec = build_decode_step(cfg, **kw, **({} if m is None else
                                                  {"cache_struct": struct}))
            seq = [last]
            for tok in want["inputs"]:
                t, lg, cache = dec(params, cache, {"tokens": torch.from_numpy(tok)})
                seq += [t, lg]
            outs.append(seq + list(cache))
    return {"equal": all(torch.equal(a, b) for a, b in zip(*outs))}


def _audio_default_len(refs, mesh) -> dict:
    """Seamless's 'cp' prefill built without ``decode_len``: every cache
    block exactly its ``local_shard`` shape under ``cache_pspecs`` of the
    default struct (the self cache the whole source long, not the rank's
    block of the frames), and the last hidden and the caches within 2e-4
    (1 + |b|) of JAX's (its self cache, ``decode_len`` long, zero-padded:
    the slots past the one-token prefix hold zeros)."""
    _, tree, batch, want = refs[AUDIO]
    cfg = _port_cfg(AUDIO)
    defs = get_module(cfg).param_defs(cfg)
    pspecs = sharding.model_param_pspecs(cfg, mesh, defs, profile=CP)
    params = sharding.tree_local_shard(from_jax_params(tree, device="cpu"), pspecs, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    struct = prefill_cache_struct(cfg, tb)
    specs = sharding.cache_pspecs(cfg, mesh, struct, CP)
    with torch.inference_mode():
        last, cache = build_prefill_step(cfg, mesh=mesh, profile=CP)(params, tb)
    err = _err(last.numpy(), want["last"])
    for f in ("self_k", "self_v", "cross_k", "cross_v"):
        got = sharding.gather_full(getattr(cache, f), getattr(specs, f), mesh)
        ref, w = np.zeros(got.shape, np.float32), want["prefill_cache"][f]
        common = tuple(slice(0, min(m, n)) for m, n in zip(got.shape, w.shape))
        ref[common] = w[common]            # JAX's self cache is decode_len long
        err = max(err, _err(got.float().numpy(), ref))
    return {"shapes_ok": _shapes_ok(cache, specs, struct, mesh), "err": err}


def _launcher_rank(profile: str = "tp") -> dict:
    return tserve.main(["--arch", DENSE, "--reduced", "--batch", "2", "--prompt-len",
                        "16", "--gen", "6", "--device", "cpu", "--mesh", "1x2",
                        "--profile", profile])


def _two_rank(refs: dict) -> dict:
    """One rank of the (1, 2) world: the MoE under '2d' and 'tp' (no data
    split: the unsharded capacity), h2o at window 8 and at a prompt of 31,
    the vocabulary tie, the merge with an empty block, the (1, 1) mesh on
    rank 0, and the launcher."""
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {(MOE, p): _serve_rank(MOE, refs[MOE], mesh, p) for p in ("2d", "tp")}
    for name in ("window8", "prompt31"):
        out[name] = _serve_rank(name, refs[name], mesh, "tp")
    for name in ("window8", "prompt31", "window24", "rg1x4", "rwkv6-1.6b", HYBRID):
        out[(name, CP)] = _serve_rank(name, refs[name], mesh, CP)
    out["audio_default_len"] = _audio_default_len(refs, mesh)
    out["tie"] = _tie_case(mesh)
    out["merge"] = _merge_case(mesh)
    if mesh.coords["model"] == 0:
        out["one_one"] = _one_one(refs)
    out["launcher"] = _launcher_rank()
    out["launcher_cp"] = _launcher_rank(CP)
    return out


@pytest.fixture(scope="module")
def worlds(jax_serve):
    four = mesh_lib.spawn_local(4, _four_rank, jax_serve, device="cpu",
                                timeout_s=WORLD_S)
    two = mesh_lib.spawn_local(2, _two_rank, jax_serve, device="cpu",
                               timeout_s=WORLD_S)
    return four, two


def _held(res: dict, what: str) -> None:
    for key in ("last", "prefill_cache", "logits", "cache"):
        assert res[key] <= PARITY, f"{what}: {key} error {res[key]:.3e}"
    assert res["tokens_equal"], f"{what}: greedy tokens differ from JAX's"
    assert res["shapes_ok"], f"{what}: a cache block is not its local_shard shape"


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_serves_on_a_2x2_world_as_the_reference(worlds, arch):
    """Each family's reduced config on (data 2, model 2) under '2d', 'tp'
    and 'fsdp': a 4 x 32 prefill and 8 decode steps teacher-forced on
    JAX's tokens, on every rank the gathered last hidden, both caches and
    every step's logits within 2e-4 (1 + |b|) of JAX's unsharded steps
    (the MoE under '2d' / 'tp' of JAX's steps with the (2, 2) mesh
    installed: shard-local capacity), the port's greedy tokens JAX's, and
    every cache block exactly the shape ``local_shard`` gives it under
    ``cache_pspecs``."""
    four, _ = worlds
    for r, rank in enumerate(four):
        for profile in PROFILES:
            _held(rank[(arch, profile)], f"{arch} {profile} rank {r}")


def test_the_moe_on_1x2_keeps_the_unsharded_capacity(worlds):
    """qwen2-moe-a2.7b on (data 1, model 2) under '2d' and 'tp': the
    expert-parallel MoE in prefill and decode, one data shard, so the
    capacity is the unsharded one and JAX's unsharded steps are the
    reference (decode's capacity drops claims at B = 4 by design)."""
    _, two = worlds
    for r, rank in enumerate(two):
        for profile in ("2d", "tp"):
            _held(rank[(MOE, profile)], f"(1, 2) {profile} rank {r}")


def test_a_ring_whose_writes_wrap_across_both_ranks(worlds):
    """h2o at window 8 on (1, 2): the 32-token prompt's banded prefill into
    a ring of 8 slots, 4 a rank, and 8 decode steps whose writes go round
    the ring through both ranks' blocks."""
    _, two = worlds
    for r, rank in enumerate(two):
        _held(rank["window8"], f"window 8 rank {r}")


def test_a_prompt_model_does_not_divide_keeps_the_cache_whole(worlds):
    """h2o with a prompt of 31 on (1, 2): ``cache_pspecs`` leaves the
    31-slot cache whole, each rank attends its heads against all of it."""
    _, two = worlds
    for r, rank in enumerate(two):
        _held(rank["prompt31"], f"prompt 31 rank {r}")


def test_a_vocabulary_tie_takes_the_lowest_global_index(worlds):
    """``greedy_token`` on the vocabulary split over 'model': a maximum on
    both ranks goes to the lower global index, two on one rank to the
    lower, a padded entry never wins; every rank gives the same tokens,
    those of the whole logits' argmax."""
    _, two = worlds
    for rank in two:
        assert rank["tie"]["token"] == [5, 150, 40] == rank["tie"]["plain"]


def test_merge_partials_over_ranks_with_an_empty_block(worlds):
    """On (1, 2), 5 valid slots of 12: rank 1's block is all masked (m =
    NEG_INF, l = 0) and adds nothing; the merge equals
    ``decode_attention`` over the whole cache."""
    _, two = worlds
    for r, rank in enumerate(two):
        assert rank["merge"]["err"] <= 1e-6, rank["merge"]
    assert two[1]["merge"]["l"] == 0.0
    assert two[1]["merge"]["m"] == float(np.float32(attn_lib.NEG_INF))


@pytest.mark.parametrize("blocks", [(7, 5), (3, 4, 5)])
def test_merge_partials_of_local_blocks_equals_decode_attention(blocks):
    """``merge_partials`` of 2 and 3 blocks of a 12-slot cache held in one
    process, 5 slots valid so that the last block is all masked, against
    ``decode_attention`` over the whole cache."""
    q, k, v = _partials()
    parts, start = [], 0
    for n in blocks:
        slots = torch.arange(start, start + n)
        parts.append(attn_lib.decode_attention_partial(
            q, k[:, :, start:start + n], v[:, :, start:start + n], slots, torch.tensor(5)))
        start += n
    assert float(parts[-1][2].max()) == 0.0
    got = attn_lib.merge_partials(parts)
    want = attn_lib.decode_attention(q, k, v, torch.tensor(5))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_a_mesh_of_one_rank_serves_the_same_bits(worlds):
    """A (1, 1) mesh's sharded prefill and decode steps give the no-mesh
    steps' last hidden, tokens, logits and cache bit for bit."""
    _, two = worlds
    assert two[0]["one_one"]["equal"]


def test_the_launcher_on_a_mesh_prints_the_one_device_tokens(worlds):
    """``launch.serve --mesh 1x2 --profile tp --device cpu`` in a world of
    two ranks: both return the one-device launcher's greedy tokens."""
    _, two = worlds
    want = tserve.main(["--arch", DENSE, "--reduced", "--batch", "2", "--prompt-len",
                        "16", "--gen", "6", "--device", "cpu"])["tokens"]
    for rank in two:
        np.testing.assert_array_equal(rank["launcher"]["tokens"], want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_serves_under_cp_on_a_2x2_world_as_the_reference(worlds, arch):
    """Each family's reduced config on (data 2, model 2) under 'cp': the
    4 x 32 prompt's rows over 'data' and its sequence over 'model' (16
    positions a rank; the encoder-decoder's frames, its one-token decoder
    prefix whole), the parameters whole over 'model'; on every rank the
    gathered last hidden, both caches and every step's logits within 2e-4
    (1 + |b|) of JAX's unsharded steps (the MoE's too: it routes the global
    batch), the greedy tokens JAX's, and every cache block exactly the
    shape ``local_shard`` gives it under ``cache_pspecs(..., "cp")``."""
    four, _ = worlds
    for r, rank in enumerate(four):
        _held(rank[(arch, CP)], f"{arch} cp rank {r}")


@pytest.mark.parametrize("case", ["window8", "prompt31", "window24", "rg1x4"])
def test_cp_edge_cases_on_1x2(worlds, case):
    """On (data 1, model 2) under 'cp': h2o at window 8 (the ring's 8
    positions all on rank 1, its slots 4 a rank), at a prompt of 31 (which
    'model' does not divide: the prompt and the cache stay whole), at
    window 24 (the ring's positions 8 ... 31 from both ranks), and
    RecurrentGemma on a 1 x 4 prompt (2 positions a rank: rank 1's
    convolution reads 3 inputs, 2 of rank 0's and a zero before the
    sequence); each held to JAX's unsharded steps as above."""
    _, two = worlds
    for r, rank in enumerate(two):
        _held(rank[(case, CP)], f"{case} cp rank {r}")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", HYBRID])
def test_cp_states_and_last_hidden_are_the_same_on_both_ranks(worlds, arch):
    """RWKV-6's and RecurrentGemma's prefill under 'cp' on (1, 2): the last
    hidden state (replicated over 'model') and every state the sequence
    leaves (RWKV-6's ``state`` / ``shift_tm`` / ``shift_cm``,
    RecurrentGemma's ``rec_h`` / ``conv_state``), gathered from the ranks'
    blocks, have the same bits on both ranks, and the serving holds to JAX
    as above."""
    _, two = worlds
    a, b = (rank[(arch, CP)] for rank in two)
    _held(a, f"{arch} cp rank 0")
    _held(b, f"{arch} cp rank 1")
    assert len(a["left"]) == len(b["left"]) > 1
    for x, y in zip(a["left"], b["left"]):
        np.testing.assert_array_equal(x, y)


def test_the_encoder_decoders_cp_prefill_without_decode_len(worlds):
    """Seamless on (1, 2) under 'cp' with no ``decode_len``: the frames
    split over 'model' (16 a rank), the self cache sized by the whole
    source (32 slots, ``prefill_cache_struct``'s default), each block its
    ``local_shard`` shape and held to JAX's prefill on both ranks."""
    _, two = worlds
    for r, rank in enumerate(two):
        res = rank["audio_default_len"]
        assert res["shapes_ok"], f"rank {r}: a cache block is not its local_shard shape"
        assert res["err"] <= PARITY, f"rank {r}: error {res['err']:.3e}"


def test_the_launcher_under_cp_prints_the_one_device_tokens(worlds):
    """``launch.serve --mesh 1x2 --profile cp --device cpu``: each rank
    prefills 8 of the 16 prompt positions and both return the one-device
    launcher's greedy tokens."""
    _, two = worlds
    want = tserve.main(["--arch", DENSE, "--reduced", "--batch", "2", "--prompt-len",
                        "16", "--gen", "6", "--device", "cpu"])["tokens"]
    for rank in two:
        np.testing.assert_array_equal(rank["launcher_cp"]["tokens"], want)


# ---------------------------------------------------------------------------
# launch.specs against the reference
# ---------------------------------------------------------------------------


def _spec_pairs(jtree, ttree):
    return jax.tree.leaves(jtree), _leaves(ttree)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_of_serving_cells_equal_the_reference(arch, kind):
    """Every arch's prefill and decode inputs: the same entries, shapes and
    dtypes as ``repro/launch/specs.py``'s, at a cut shape and at the
    reference's own."""
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    name = "prefill_32k" if kind == "prefill" else "decode_32k"
    for seq, batch in ((64, 4), (SHAPES_BY_NAME[name].seq_len,
                                 SHAPES_BY_NAME[name].global_batch)):
        jshape = dataclasses.replace(SHAPES_BY_NAME[name], seq_len=seq, global_batch=batch)
        want = j_input_specs(jcfg, jshape)
        got = input_specs(tcfg, TC.ShapeConfig(name, kind, seq, batch))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.shape == tuple(want[k].shape), (k, seq)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), (k, seq)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch):
    """Every arch's decode cache (``init_cache`` on the meta device): the
    reference's ``cache_specs`` leaf for leaf, shape and dtype, at a cut
    shape and at ``decode_32k``."""
    jcfg, tcfg = jget(arch), TC.get_config(arch)
    for seq, batch in ((48, 2), (32768, 128)):
        jshape = dataclasses.replace(SHAPES_BY_NAME["decode_32k"], seq_len=seq,
                                     global_batch=batch)
        want = j_cache_specs(jcfg, jshape)
        got = cache_specs(tcfg, TC.ShapeConfig("decode_32k", "decode", seq, batch))
        assert type(got)._fields == type(want)._fields
        jl, tl = _spec_pairs(want, got)
        assert len(jl) == len(tl)
        for w, g in zip(jl, tl):
            assert g.shape == tuple(w.shape) and \
                str(g.dtype).split(".")[-1] == str(w.dtype), (arch, seq)


def _leaves(cache) -> list:
    out = []
    for f in cache._fields:
        v = getattr(cache, f)
        out += list(v) if isinstance(v, list) else [v]
    return out


def test_prefill_cache_struct_is_the_prefills_cache():
    """``prefill_cache_struct`` has the shapes and dtypes of the cache each
    family's prefill makes (the encoder-decoder's self cache
    ``decode_len`` long), the struct the sharded steps lay out."""
    from repro_torch.models.params import init_params
    for arch in FAMILIES:
        cfg = TC.reduced(TC.get_config(arch))
        params = from_jax_params(init_params(0, get_module(cfg).param_defs(cfg)),
                                 device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in _prompt(cfg, 2, 12).items()}
        dlen = _decode_len(cfg, 12)
        with torch.inference_mode():
            _, cache = build_prefill_step(cfg, decode_len=dlen)(params, tb)
        want, got = _leaves(cache), _leaves(prefill_cache_struct(cfg, tb, dlen))
        assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want], arch
        assert [t.dtype for t in got] == [t.dtype for t in want], arch
