"""Serving launcher of the port: batched prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      [--reduced] [--batch 4] [--prompt-len 64] [--gen 32] [--seed 0] \
      [--device cuda|cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch h2o-danube-1.8b --reduced \
      --mesh 1x2 [--profile 2d|tp|fsdp|cp] [--device cpu]

Port of ``repro/launch/serve.py`` for every ported arch (``configs.ARCHS``:
RWKV-6, the dense and MoE transformers, Qwen2-VL, the Seamless
encoder-decoder and the RecurrentGemma hybrid).  Weights come from
``--seed``: on the card drawn there (the model's ``init_on_device``, as
the reference jits its ``init_params`` onto the device: the uncut
starcoder2-15b's 16 B parameters in seconds, and no float32 copy of a
leaf made whole), on the CPU ``params.init_params`` (numpy); the two
give other numbers.  Prompts come from
``np.random.default_rng(seed)`` (and, where the config takes embedding
inputs, the prompt's ``inputs_embeds`` drawn after the tokens: for the
encoder-decoder they are the source frames, the tokens' first column is
the decoder's prefix and its self cache is sized for prompt + gen), and
decode starts from token 0, as in the JAX launcher.  ``--device``
defaults to ``cuda`` and the run raises where there is no card;
``--device cpu`` runs the plain versions on the CPU.

On the card the steps are captured, as the reference jits them: the
prefill as ``captured(partial(prefill, params))`` and the decode step as
``captured(partial(donating(decode, 1), params))`` (``jax.jit(decode,
donate_argnums=(1,))``), both in one graph pool (``runtime.capture``).
Both are captured for the run's (B, S) and B before the timed calls, and
the capture's host seconds are printed on a line of their own.  The
printed prefill ms and ms/token are then the replays', timed with CUDA
events.  This is one deliberate difference from the reference, whose
``t_prefill`` (and first decode step) include the compile.  On the CPU the
eager steps run, timed by the host clock.

``--mesh DATAxMODEL`` (``launch.mesh.make_mesh`` over the world) or
``--production-mesh`` (16 x 16) serves under a mesh, as the reference's
launcher always does, under ``torchrun --standalone --nproc-per-node N``
or ``launch.mesh.spawn_local`` (each rank calls ``main``): the sharded
prefill and decode steps (``runtime.build_prefill_step`` /
``build_decode_step`` with ``mesh=`` and ``--profile``, '2d' by default as
the reference's launcher lays its parameters out; 'tp', 'fsdp' and 'cp'
too, 'cp' splitting the prompt's sequence over 'model').  Each rank draws
the whole tree
from the seed as one device does and keeps a copy of its block of each
leaf (``sharding.local_shard``), makes the same global prompt, and its
steps take their block of it; each step's greedy tokens are gathered over
the dp axes for the next step, and rank 0 prints them, so that a mesh
changes no token.  On a mesh where no axis has more than one rank the
steps are captured as without one; where a collective crosses ranks (gloo
stages every one through the host) they run eager
(``runtime.capture.capturable``), and the launcher prints which.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import get_module
from repro_torch.models.params import PartitionSpec, init_params, tree_map
from repro_torch.runtime import build_decode_step, build_prefill_step, sharding
from repro_torch.runtime.capture import capturable, captured, donating
from repro_torch.runtime.steps import prefill_cache_struct


def timed(fn: Callable, device: torch.device):
    """(fn(), milliseconds): CUDA events on the card, host clock else."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _prefill(cfg: ModelConfig, params, mesh=None, profile: str = "2d") -> Callable:
    """prefill(batch, decode_len=None) with ``params`` bound: the step
    ``build_prefill_step(cfg, decode_len=decode_len, mesh=mesh,
    profile=profile)`` builds.  Captured, it keeps one graph for each value
    of ``decode_len``, as it does for each shape."""
    def prefill(batch, decode_len=None):
        return build_prefill_step(cfg, decode_len=decode_len, mesh=mesh,
                                  profile=profile)(params, batch)
    return prefill


def eager_steps(cfg: ModelConfig, params, mesh=None, profile: str = "2d",
                cache_struct=None) -> Tuple[Callable, Callable]:
    """(prefill(batch, decode_len=None), decode(cache, batch)): the eager
    steps with ``params`` bound; under a ``mesh`` the sharded ones, the
    decode step laying out a cache of ``cache_struct``'s shapes."""
    decode = build_decode_step(cfg, mesh=mesh, profile=profile, cache_struct=cache_struct)
    return _prefill(cfg, params, mesh, profile), functools.partial(decode, params)


def captured_steps(cfg: ModelConfig, params, mesh=None, profile: str = "2d",
                   cache_struct=None) -> Tuple[Callable, Callable]:
    """The same steps captured, as the reference jits them: the prefill,
    and the decode step with its cache donated; one graph pool."""
    pool = torch.cuda.graph_pool_handle()
    decode = donating(build_decode_step(cfg, mesh=mesh, profile=profile,
                                        cache_struct=cache_struct), 1)
    return (captured(_prefill(cfg, params, mesh, profile), pool=pool),
            captured(functools.partial(decode, params), pool=pool))


def call_prefill(prefill: Callable, batch: dict, decode_len: Optional[int] = None):
    """``prefill(batch)``, or ``prefill(batch, decode_len)`` where there is a
    ``decode_len``: one way of calling for each, so that a captured prefill
    sees one signature (and keeps one graph) whoever calls it."""
    return prefill(batch) if decode_len is None else prefill(batch, decode_len)


def run_prefill(prefill: Callable, tokens: torch.Tensor,
                inputs_embeds: Optional[torch.Tensor] = None,
                decode_len: Optional[int] = None, *,
                positions: Optional[torch.Tensor] = None):
    """``call_prefill`` on tokens [B, S] (and ``inputs_embeds`` [B, S, D],
    M-RoPE ``positions`` [3, B, S] where given) -> (last hidden [B, D],
    cache, ms)."""
    batch = {"tokens": tokens}
    if inputs_embeds is not None:
        batch["inputs_embeds"] = inputs_embeds
    if positions is not None:
        batch["positions"] = positions
    with torch.inference_mode():
        (last, cache), ms = timed(lambda: call_prefill(prefill, batch, decode_len),
                                  tokens.device)
    return last, cache, ms


def run_decode(decode: Callable, cache, batch: int, gen: int,
               device: torch.device, gather: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, List[torch.Tensor], object, float]:
    """``gen`` greedy steps of ``decode(cache, batch)`` from token 0 ->
    (tokens [B, gen] int32, logits of each step [B, Vp], the last cache, ms
    for all steps).  ``gather``: the whole batch's tokens from a step's
    (a sharded step's rank's block), each step's input."""
    def loop(cache):
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        toks, logits = [], []
        for _ in range(gen):
            tok1, lg, cache = decode(cache, {"tokens": tok})
            if gather is not None:
                tok1 = gather(tok1)
            tok = tok1[:, None]
            toks.append(tok1)
            logits.append(lg)
        return torch.stack(toks, 1), logits, cache

    with torch.inference_mode():
        (toks, logits, cache), ms = timed(lambda: loop(cache),
                                          torch.device(device))
    return toks, logits, cache, ms


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels, steps "
                         "captured as CUDA graphs) or cpu (the plain "
                         "versions, eager)")
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL: serve on a mesh over the world's ranks")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--profile", default="2d", choices=sharding.PROFILES,
                    help="the mesh's layout: 2d (FSDP over data, TP over "
                         "model), tp (TP over model, data-parallel over data), "
                         "fsdp (the whole mesh FSDP / data-parallel) or cp "
                         "(FSDP over data, the prompt's sequence over model)")
    args = ap.parse_args(argv)

    meshed = bool(args.mesh or args.production_mesh)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: --device cuda (the default) but no CUDA "
                           "device is available; pass --device cpu to run "
                           "the plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mod = get_module(cfg)

    mesh = None
    if meshed:
        mesh_lib.init_from_env(device)
        if args.production_mesh:
            mesh = mesh_lib.make_production_mesh(device=device)
        else:
            data, model = (int(n) for n in args.mesh.lower().split("x"))
            mesh = mesh_lib.make_mesh((data, model), ("data", "model"), device=device)
        device = mesh.device
    lead = mesh is None or dist.get_rank() == 0
    tree = (mod.init_on_device(cfg, args.seed, device=device) if device.type == "cuda"
            else init_params(args.seed, mod.param_defs(cfg)))
    params = mod.load_params(cfg, tree, device=device)
    del tree
    if mesh is not None:           # the rank keeps its block of each leaf
        pspecs = sharding.model_param_pspecs(cfg, mesh, mod.param_defs(cfg),
                                             profile=args.profile)
        params = tree_map(lambda x, spec, path: sharding.local_shard(x, spec, mesh)
                          .clone(memory_format=torch.contiguous_format), params, pspecs)

    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)).to(device)
    embeds = None
    if cfg.embedding_inputs:
        embeds = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(device)
        if cfg.family == "audio":
            tokens = tokens[:, :1]
    total = S + args.gen if cfg.family == "audio" else None
    struct, gather = None, None
    if mesh is not None:
        batch = {"tokens": tokens} if embeds is None else {"tokens": tokens,
                                                           "inputs_embeds": embeds}
        struct = prefill_cache_struct(cfg, batch, total)
        rows = sharding.batch_pspecs(cfg, mesh, {"tokens": tokens[:, :1]},
                                     args.profile)["tokens"][0]
        gather = lambda t: sharding.gather_full(t, PartitionSpec(rows), mesh)  # noqa: E731
    steps = (mesh, args.profile, struct)
    if device.type == "cuda" and capturable(mesh):
        prefill, decode = captured_steps(cfg, params, *steps)
        # capture both at the run's shapes (the first call at a signature
        # captures it) before the timed calls
        _, cache, _ = run_prefill(prefill, tokens, embeds, total)
        run_decode(decode, cache, B, 1, device, gather)
        if lead:
            print(f"capture prefill[{B}x{S}]={prefill.capture_s[0]:.2f}s "
                  f"decode[{B}]={decode.capture_s[0]:.2f}s (host clock)")
    else:
        prefill, decode = eager_steps(cfg, params, *steps)
    if mesh is not None and lead:
        print(f"mesh={mesh.sizes} profile={args.profile}: steps "
              + ("captured (no axis of the mesh has more than one rank)"
                 if device.type == "cuda" and capturable(mesh) else
                 "eager (a collective crosses ranks)" if not capturable(mesh)
                 else "eager (the CPU)"))
    _, cache, t_prefill = run_prefill(prefill, tokens, embeds, total)
    gen, _, _, t_decode = run_decode(decode, cache, B, args.gen, device, gather)
    gen = gen.cpu().numpy()
    if lead:
        print(f"arch={cfg.name} device={device} prefill[{B}x{S}]={t_prefill:.1f}ms "
              f"decode {args.gen} steps={t_decode:.1f}ms "
              f"({t_decode / max(args.gen, 1):.2f} ms/tok)")
        print("generated (first seq):", gen[0][:16].tolist())
    return {"tokens": gen, "prefill_ms": t_prefill,
            "decode_ms_per_token": t_decode / max(args.gen, 1)}


if __name__ == "__main__":
    main()
