"""Dry-run of every (arch x shape x mesh) cell: a rank's program counted on
the meta device.  Port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 512 forced CPU devices
and reads XLA's ``cost_analysis()`` / ``memory_analysis()`` and the
partitioned HLO's collectives.  The port has no compiler: each rank runs
its own program (``runtime.steps``' builders with ``mesh=``), and that
program is the cell.  This module builds the step for the production
mesh (``launch.mesh.production_shape``: 16 x 16, or 2 x 16 x 16 with
``--multi-pod``) over ``launch.mesh.abstract_mesh`` on ``device="meta"``,
makes the rank's blocks of the parameters (``launch.specs.param_specs``
by ``sharding.model_param_pspecs``), of AdamW's moments for a train cell
and of the decode cache (``cache_specs`` by ``cache_pspecs``) as meta
tensors, hands it the global batch (``input_specs``) as the sharded steps
take it, and runs it once under ``core.opcount.OpCounter``.  Nothing is
allocated, no kernel launches (``kernels.ops`` returns empty outputs on
meta and counts each kernel by formula) and no world starts
(``runtime.collectives`` sends nothing on meta and records what it would
send).

The record has the reference's keys and meanings: ``cost_analysis`` /
``corrected`` (``flops``, ``bytes accessed``, ``transcendentals``;
``collective_wire_bytes`` and ``trip_count`` in ``corrected``),
``collectives``, ``collective_wire_bytes`` and ``memory_analysis``
(``argument_bytes``: the rank's parameters, moments, batch and cache;
``output_bytes``: what the step returns; ``alias_bytes``: what is donated,
the parameters and optimizer state of a train cell and the cache of a
decode cell; ``temp_bytes``: the trace's peak of live bytes less the
arguments held).  ``trace_s`` takes the place of ``lower_s`` /
``compile_s``; there are no ``u2_*`` keys: the eager trace counts every
layer, so ``corrected`` is the direct count, and ``trip_count`` is the
reference's layer-scan length, kept for the reader.  ``kernels`` adds
each kernel's share (``OpCounter.kernels``).

The rank counted is the one at coordinate 0 on every axis; under 'cp'
also the last rank of 'model', whose share of a sequence differs.  The
record keeps the larger of each count and ``rank_of`` names the rank each
came from where they differ: under 'cp' the last rank of 'model' holds
the sequence's end and hands the states it leaves to the others
(``runtime.collectives.from_last`` / ``scatter_from_last``), and a
train or prefill rank's attention reads more keys the later its
positions.

Records go to ``experiments/dryrun_torch/`` (never the reference's
``experiments/dryrun/``).

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun            # every cell on one mesh
  python -m repro_torch.launch.dryrun --table [--tag opt]   # the records as a table
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, applicable_shapes, get_config
from repro_torch.core import hloanalysis, opcount
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.launch.specs import TensorSpec, cache_specs, input_specs, param_specs
from repro_torch.models import get_module
from repro_torch.models.params import tree_map
from repro_torch.optim import AdamWState, warmup_cosine
from repro_torch.runtime import (build_decode_step, build_prefill_step,
                                 build_train_step, collectives, sharding)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COST_KEYS = ("flops", "bytes accessed", "transcendentals")


def _block(spec: TensorSpec, pspec, mesh, gen=None) -> torch.Tensor:
    """A tensor of the rank's block of ``spec`` under ``pspec`` on the
    mesh's device: empty on meta; elsewhere a float block drawn from
    N(0, 0.02^2) by ``gen`` and an integer one zeros (token 0, step 0)."""
    shape = list(spec.shape)
    for dim, (_, n) in enumerate(sharding.shard_index(pspec, mesh)):
        if shape[dim] % n:
            raise ValueError(f"dryrun: dim {dim} of {spec.shape} is not "
                             f"divisible by {n} ({pspec})")
        shape[dim] //= n
    if mesh.device.type == "meta":
        return torch.empty(shape, dtype=spec.dtype, device="meta")
    if not spec.dtype.is_floating_point:
        return torch.zeros(shape, dtype=spec.dtype, device=mesh.device)
    return (0.02 * torch.randn(shape, generator=gen, device=mesh.device)).to(spec.dtype)


def _blocks(struct, pspecs, mesh, gen=None):
    if hasattr(struct, "_fields"):                     # a cache NamedTuple
        return type(struct)(**{f: _blocks(getattr(struct, f), getattr(pspecs, f), mesh, gen)
                               for f in struct._fields})
    if isinstance(struct, list) and not isinstance(pspecs, sharding.P):
        return [_blocks(s, p, mesh, gen) for s, p in zip(struct, pspecs)]
    if isinstance(struct, TensorSpec):
        return _block(struct, pspecs, mesh, gen)
    return tree_map(lambda s, p, path: _block(s, p, mesh, gen), struct, pspecs)


def _bytes(tree) -> int:
    return opcount.nbytes(*opcount.tensors(tree))


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def build_cell(cfg, shape, mesh, *, profile: str = "2d", serve_bf16: bool = False,
               ibn_chunks: int = 0, seed: int = 0):
    """(step, args, donated, batch bytes) of one rank's program:
    ``cfg``'s step for ``shape`` (a ``ShapeConfig``) over ``mesh`` (an
    ``abstract_mesh`` whose coordinates are the rank's, or a world's mesh),
    its arguments the rank's blocks on the mesh's device (``_block``; the
    global batch, as the sharded steps take it), ``donated`` the arguments
    the reference donates, ``batch bytes`` each batch entry's rank's block's."""
    gen = None
    if mesh.device.type != "meta":
        gen = torch.Generator(mesh.device).manual_seed(seed)
    defs = get_module(cfg).param_defs(cfg)
    pspecs = sharding.model_param_pspecs(cfg, mesh, defs, profile=profile)
    p_struct = param_specs(cfg, serve_bf16=serve_bf16 and shape.kind == "decode")
    b_struct = input_specs(cfg, shape)
    b_pspecs = sharding.batch_pspecs(cfg, mesh, b_struct, profile)
    batch = {k: _block(s, sharding.P(*([None] * len(s.shape))), mesh, gen)
             for k, s in b_struct.items()}
    batch_bytes = {k: opcount.nbytes(sharding.local_shard(batch[k], b_pspecs[k], mesh))
                   for k in b_struct}
    params = _blocks(p_struct, pspecs, mesh, gen)

    if shape.kind == "train":
        step = build_train_step(cfg, lr_schedule=warmup_cosine(3e-4, 100, 10_000),
                                ibn_chunks=ibn_chunks, mesh=mesh, profile=profile)
        opt = AdamWState(count=torch.zeros((), dtype=torch.int32, device=mesh.device),
                         m=tree_map(lambda p, path: torch.zeros_like(p), params),
                         v=tree_map(lambda p, path: torch.zeros_like(p), params))
        args, donated = (params, opt, batch), (params, opt)
    elif shape.kind == "prefill":
        step = build_prefill_step(cfg, decode_len=shape.seq_len, mesh=mesh,
                                  profile=profile)
        args, donated = (params, batch), ()
    else:
        c_struct = cache_specs(cfg, shape)
        step = build_decode_step(cfg, mesh=mesh, profile=profile, cache_struct=c_struct)
        cache = _blocks(c_struct, sharding.cache_pspecs(cfg, mesh, c_struct, profile),
                        mesh, gen)
        args, donated = (params, cache, batch), (cache,)
    return step, args, donated, batch_bytes


def count(step, args, donated, batch_bytes: Dict[str, int], *,
          train: bool) -> Dict[str, Any]:
    """One run of ``step(*args)`` under an ``OpCounter`` and a fresh
    collectives record: the record's counts (module docstring).  The
    arguments are the ones the program reads (XLA's executable takes no
    argument its program does not use): the rank's blocks, and its block of
    each batch entry, ``batch_bytes``."""
    collectives.reset_record()
    t0 = time.time()
    with opcount.OpCounter() as counter:
        counter.hold(*opcount.tensors(args[:-1]))
        with torch.set_grad_enabled(train):
            out = step(*args)
    trace_s = time.time() - t0
    stats = hloanalysis.collective_stats(collectives.record)
    collectives.reset_record()
    return {
        "trace_s": round(trace_s, 2),
        "cost_analysis": {"flops": counter.flops,
                          "bytes accessed": counter.bytes_accessed,
                          "transcendentals": counter.transcendentals},
        "kernels": counter.kernels(),
        "memory_analysis": {
            "argument_bytes": sum(opcount.nbytes(t) for t in opcount.tensors(args[:-1])
                                  if counter.read(t))
            + sum(n for k, n in batch_bytes.items() if counter.read(args[-1][k])),
            "output_bytes": _bytes(out),
            "temp_bytes": counter.peak_bytes - counter.held_bytes,
            "alias_bytes": _bytes(donated),
        },
        "collectives": {op: {"count": st.count, "result_bytes": st.result_bytes,
                             "operand_bytes": st.operand_bytes,
                             "wire_bytes": st.wire_bytes(op)}
                        for op, st in stats.items()},
        "collective_wire_bytes": hloanalysis.collective_wire_bytes(stats),
        "peak_bytes": counter.peak_bytes,
    }


def trace(cfg, shape, mesh, **kw) -> Dict[str, Any]:
    """The counts of one rank's program (``build_cell``'s keywords), run
    once on the mesh's device: a trace on ``meta``."""
    step, args, donated, batch_bytes = build_cell(cfg, shape, mesh, **kw)
    return {"kind": shape.kind, "rank": dict(mesh.coords),
            **count(step, args, donated, batch_bytes, train=shape.kind == "train")}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               ibn_chunks: int = 0, extra_tag: str = "", profile: str = "2d",
               serve_bf16: bool = False,
               coords: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """One rank's record of the cell on the production mesh: the rank at
    ``coords`` (coordinate 0 on every axis where None)."""
    mesh_shape, axes = production_shape(multi_pod)
    mesh = abstract_mesh(mesh_shape, axes, coords or {a: 0 for a in axes},
                         device="meta")
    counts = trace(get_config(arch), SHAPES_BY_NAME[shape_name], mesh,
                   profile=profile, serve_bf16=serve_bf16, ibn_chunks=ibn_chunks)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "ibn_chunks": ibn_chunks, "profile": profile, "serve_bf16": serve_bf16,
        **counts}
    if extra_tag:
        record["tag"] = extra_tag
    return record


def _scan_trip_count(arch: str) -> int:
    """Iterations of the reference's layer scan (1 where its layers are a
    python loop)."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":        # recurrentgemma: unrolled python loop
        return 1
    return cfg.num_layers


def _merge(records: list) -> Dict[str, Any]:
    """The first record with each count the largest of the records', and
    ``rank_of``: the rank each came from where the records differ."""
    out = json.loads(json.dumps(records[0]))
    rank_of: Dict[str, Dict[str, int]] = {}

    def walk(dst, srcs, path):
        for key, val in dst.items():
            vals = [s.get(key) for s in srcs]
            where = f"{path}{key}"
            if isinstance(val, dict):
                walk(val, [v if isinstance(v, dict) else {} for v in vals], where + ".")
            elif isinstance(val, (int, float)) and not isinstance(val, bool):
                nums = [v if isinstance(v, (int, float)) else 0 for v in vals]
                i = max(range(len(nums)), key=nums.__getitem__)
                dst[key] = nums[i]
                if len(set(nums)) > 1:
                    rank_of[where] = records[i]["rank"]

    for section in ("cost_analysis", "kernels", "memory_analysis", "collectives"):
        for r in records[1:]:                  # kinds only another rank has
            for key, val in r.get(section, {}).items():
                out[section].setdefault(key, json.loads(json.dumps(val)))
        walk(out[section], [r.get(section, {}) for r in records], section + ".")
    for key in ("collective_wire_bytes", "peak_bytes"):
        out[key] = max(r[key] for r in records)
    out["ranks"] = [r["rank"] for r in records]
    out["rank_of"] = rank_of
    del out["rank"]
    return out


def analyse_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 ibn_chunks: int = 0, extra_tag: str = "", profile: str = "2d",
                 serve_bf16: bool = False) -> Dict[str, Any]:
    """The cell's record (module docstring): rank 0's program, and under
    'cp' also the last rank of 'model', the larger of each count kept."""
    kw = dict(multi_pod=multi_pod, ibn_chunks=ibn_chunks, extra_tag=extra_tag,
              profile=profile, serve_bf16=serve_bf16)
    recs = [lower_cell(arch, shape_name, **kw)]
    if profile == "cp":
        mesh_shape, axes = production_shape(multi_pod)
        last = {a: 0 for a in axes}
        last["model"] = dict(zip(axes, mesh_shape))["model"] - 1
        recs.append(lower_cell(arch, shape_name, coords=last, **kw))
    rec = _merge(recs)
    rec["trace_s"] = round(sum(r["trace_s"] for r in recs), 2)
    rec["corrected"] = {
        **{k: rec["cost_analysis"][k] for k in COST_KEYS},
        "collective_wire_bytes": rec["collective_wire_bytes"],
        "trip_count": _scan_trip_count(arch),
    }
    return rec


def roofline(rec: Dict[str, Any]) -> hloanalysis.Roofline:
    """The cell's roofline terms from its record's counts."""
    c = rec["corrected"]
    return hloanalysis.Roofline(c["flops"], c["bytes accessed"],
                                c["collective_wire_bytes"])


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> Path:
    mesh = "pod2" if multi_pod else "pod1"
    suffix = f"-{tag}" if tag else ""
    return ARTIFACT_DIR / f"{arch}__{shape}__{mesh}{suffix}.json"


def summary_line(rec: Dict[str, Any]) -> str:
    ca, ma = rec["corrected"], rec["memory_analysis"]
    rf = roofline(rec)
    return (f"  trace={rec['trace_s']}s flops={ca['flops']:.3e} "
            f"bytes={ca['bytes accessed']:.3e} "
            f"coll={ca['collective_wire_bytes']:.3e} "
            f"args={ma['argument_bytes']:.3e} temp={ma['temp_bytes']:.3e} "
            f"step_s={rf.step_s:.3e} ({rf.bound})")


def table(tag: str = "") -> str:
    """A markdown table of the records under ``ARTIFACT_DIR`` with ``tag``:
    a row a cell, each column its count on 16 x 16 / 2 x 16 x 16 ("-"
    where a record is missing), ``step_s`` with the term that bounds it."""
    head = ("| cell | profile | FLOPs | bytes accessed | collective wire bytes | "
            "argument bytes | temp bytes | step_s (bound) |")
    rows = [head, "|---" * 8 + "|"]
    for arch in sorted(ARCHS):
        for shape in applicable_shapes(get_config(arch)):
            recs = [json.loads(p.read_text()) if p.exists() else None
                    for p in (cell_path(arch, shape.name, mp, tag) for mp in (False, True))]

            def pair(fn):
                return " / ".join("-" if r is None else fn(r) for r in recs)

            def num(section, key):
                return pair(lambda r: f"{r[section][key]:.3g}")

            rows.append(" | ".join([
                f"| {arch} {shape.name}",
                pair(lambda r: r["profile"] + (" bf16" if r["serve_bf16"] else "")),
                *(num("corrected", k) for k in ("flops", "bytes accessed",
                                                "collective_wire_bytes")),
                *(num("memory_analysis", k) for k in ("argument_bytes", "temp_bytes")),
                pair(lambda r: f"{roofline(r).step_s:.3g} ({roofline(r).bound})")]) + " |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ibn-chunks", type=int, default=0)
    ap.add_argument("--profile", default="2d", choices=["2d", "fsdp", "tp", "cp"])
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the records with --tag as a markdown table and stop")
    args = ap.parse_args()
    if args.table:
        print(table(args.tag))
        return

    cells = []
    for arch in ([args.arch] if args.arch else sorted(ARCHS)):
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            if args.shape and shape.name != args.shape:
                continue
            cells.append((arch, shape.name))

    if args.list:
        for c in cells:
            print(*c)
        return

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    for arch, shape in cells:
        out = cell_path(arch, shape, args.multi_pod, args.tag)
        if out.exists() and not args.force:
            print(f"skip {out.name} (exists)")
            continue
        print(f"=== {arch} x {shape} ({_mesh_name(args.multi_pod)}) ===", flush=True)
        rec = analyse_cell(arch, shape, multi_pod=args.multi_pod,
                           ibn_chunks=args.ibn_chunks, extra_tag=args.tag,
                           profile=args.profile, serve_bf16=args.serve_bf16)
        out.write_text(json.dumps(rec, indent=1))
        print(summary_line(rec), flush=True)


if __name__ == "__main__":
    main()
