"""Meshes over ``torch.distributed``, and a spawner of local worlds.

Port of ``repro/launch/mesh.py``.  A JAX mesh is an array of devices with
named axes, and ``shard_map`` runs one program a device.  Here each device
is a process (a rank) and the program is that rank's own: a ``Mesh``
gives the rank its coordinates on the named axes and one process group
for each axis, made of the ranks that differ from it along that axis only,
in the order of their coordinate.  Ranks are laid out row-major over the
mesh shape (rank = the ravelled coordinates), as ``jax.make_mesh`` lays
out its device list.

``spawn_local`` starts a world of local ranks (the port's counterpart of
``--xla_force_host_platform_device_count``): one process a rank, a
``file://`` rendezvous in a fresh temporary directory, each rank's return
value handed back, every rank killed and ``RuntimeError`` raised if any
rank fails or the world outlives its time limit.  The backend follows the
world's layout (``pick_backend``): NCCL where each rank has a card of its
own; gloo on the CPU, or where ranks share a card.  Nothing switches
backend after a failure.

Builders are functions, never module-level constants: importing this
module touches no device and starts no process.
"""
from __future__ import annotations

import datetime
import math
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Mesh:
    """Named axes over the ranks of the world.

    ``shape`` and ``axis_names`` as a JAX mesh has them; ``coords`` this
    rank's coordinate on each axis; ``groups`` one process group an axis
    (``None`` for an abstract mesh, which only lays out specs);
    ``axis_ranks`` the global ranks of this rank's group on each axis, by
    coordinate; ``device`` the rank's device; ``backend`` the world's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None,
                 axis_ranks: Optional[Dict[str, List[int]]] = None,
                 device: "torch.device | str" = "cpu",
                 backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"Mesh: shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.coords = dict(coords) if coords is not None else None
        self.groups = groups
        self.axis_ranks = axis_ranks
        self.device = torch.device(device)
        self.backend = backend

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.sizes}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str],
                  coords: Optional[Dict[str, int]] = None, *,
                  device: "torch.device | str" = "cpu") -> Mesh:
    """A mesh with no process group: the sizes that specs are laid out
    over, and optionally the coordinates that ``local_shard`` slices by.
    On ``device="meta"`` it is the dry-run's mesh: a rank's program runs
    over it on meta tensors, its collectives sending nothing
    (``runtime.collectives``), and no world is started."""
    return Mesh(shape, axis_names, coords=coords, device=device)


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: (data=16, model=16), or
    (pod=2, data=16, model=16) across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _resolve_device(device: "torch.device | str") -> torch.device:
    """``"cuda"`` -> this rank's card: ``LOCAL_RANK`` modulo the cards (ranks
    share a card where there are more ranks than cards).  Raises where no
    card is available."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("mesh: device 'cuda' but no CUDA device is "
                           "available (pass device='cpu')")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: "torch.device | str" = "cuda") -> Mesh:
    """A mesh over the initialised world, whose size must be the mesh's.
    Every rank calls this with the same arguments: the axis groups are made
    by every rank in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(run under torchrun or launch.mesh.spawn_local)")
    shape = tuple(int(n) for n in shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} holds {math.prod(shape)} "
                         f"ranks, the world has {world}")
    groups, axis_ranks = {}, {}
    for i, name in enumerate(axis_names):
        for rest in np.ndindex(*[n for j, n in enumerate(shape) if j != i]):
            ranks = []
            for c in range(shape[i]):
                idx = list(rest)
                idx.insert(i, c)
                ranks.append(int(np.ravel_multi_index(idx, shape)))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name], axis_ranks[name] = group, ranks
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
    return Mesh(shape, axis_names, coords=coords, groups=groups, axis_ranks=axis_ranks,
                device=_resolve_device(device), backend=dist.get_backend())


def make_production_mesh(*, multi_pod: bool = False,
                         device: "torch.device | str" = "cuda") -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found {world}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, model: int = 1,
                   device: "torch.device | str" = "cuda") -> Mesh:
    """(data = world / model, model) over every rank of the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide "
                         f"the world's {world} ranks")
    return make_mesh((world // model, model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# Worlds
# ---------------------------------------------------------------------------


def pick_backend(n: int, device: str, backend: Optional[str] = None,
                 cards: Optional[int] = None) -> Tuple[str, str]:
    """(backend, why) for ``n`` local ranks on ``device`` ("cpu" or "cuda"):
    NCCL where each rank has a card of its own, gloo on the CPU or where
    ranks share a card.  Asking for NCCL where it cannot run raises
    ``ValueError``; a card asked for where there is none raises
    ``RuntimeError``."""
    kind = torch.device(device).type
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; the ranks are "
                             "on the CPU")
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count() if cards is None else cards
    if cards == 0:
        raise RuntimeError(f"{n} ranks on 'cuda' but no CUDA device is "
                           f"available")
    if n > cards:
        if backend == "nccl":
            raise ValueError(f"NCCL cannot run {n} ranks on {cards} card(s): "
                             f"it takes one card a rank")
        return "gloo", f"{n} ranks share {cards} card(s)"
    return backend or "nccl", f"{n} ranks, a card each"


def init_from_env(device: "torch.device | str" = "cuda") -> str:
    """Initialise the world of a launcher: from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``), or a
    world of one rank where there is none.  Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 os.environ.get("WORLD_SIZE", "1")))
    backend, why = pick_backend(local_n, torch.device(device).type)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(_resolve_device(device))
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:                          # one rank: an in-memory store, no files
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_rank() == 0:
        print(f"world: {dist.get_world_size()} ranks, backend {backend} ({why})",
              flush=True)
    return backend


def _rank_main(rank: int, n: int, init_file: str, backend: str, device: str,
               timeout_s: float, results, fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n))
    if torch.device(device).type == "cpu":       # the ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(_resolve_device(device))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:                        # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(n: int, fn: Callable, *args, device: str = "cuda",
                backend: Optional[str] = None, timeout_s: float = 120.0) -> list:
    """Runs ``fn(*args)`` on each of ``n`` fresh local ranks (spawned
    processes, ``torch.distributed`` initialised on ``pick_backend``'s
    backend) and returns their return values by rank.  ``fn`` and its
    arguments must be picklable (a module-level function).  If a rank
    raises or dies, or the world is still running after ``timeout_s``
    seconds, every rank is killed and ``RuntimeError`` raised with the
    failing rank's traceback.  Ranks on the CPU share its cores, each
    with its share of intra-op threads."""
    backend, why = pick_backend(n, device, backend)
    print(f"spawn_local: {n} ranks on {device}, backend {backend} ({why})",
          flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, os.path.join(tmp, "init"), backend, device,
                               timeout_s, results, fn, args))
             for r in range(n)]
    out: Dict[int, object] = {}
    error = None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n and error is None:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    error = (f"the world of {n} ranks outlived its limit of "
                             f"{timeout_s:.0f} s ({len(out)} ranks done)")
                continue
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if error is None
                   else 0.5)
            if p.is_alive():
                if error is None:
                    error = (f"rank {procs.index(p)} did not exit after "
                             f"returning (limit {timeout_s:.0f} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"spawn_local: {error}")
    return [out[r] for r in range(n)]
