"""GPipe pipeline parallelism over a mesh axis, and the data-parallel
fan-out of a batched function: port of ``repro/runtime/pipeline.py``.

``gpipe``: stage s (the rank at coordinate s of the ``model`` axis) holds
layers [s·L/S, (s+1)·L/S) and microbatches stream through the ring by
``collectives.ppermute``; fill and drain cost (S−1)/(M+S−1) of the
schedule.  Gradients flow back through the same ring (ppermute's adjoint
is the reverse permutation).

``data_parallel``: each rank of an axis runs a batched function on its
B/n rows and the outputs are gathered to every rank: the serving policy's
fan-out (``serve.policy`` costs a batch-b group served as ``devices``
shards of the batch-b/devices schedule).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.runtime import collectives as C

Tree = Any


def split_stages(params: Tree, n_stages: int) -> Tree:
    """[L, ...]-stacked layer params -> [n_stages, L/S, ...]."""
    def resh(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"split_stages: {L} layers over {n_stages} stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])
    return pytree.tree_map(resh, params)


def gpipe(block_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
          stage_params: Tree, x_micro: torch.Tensor, *, mesh,
          axis: str = "model") -> torch.Tensor:
    """Run microbatches through the layer pipeline on this rank.

    block_fn     : (one stage's params [L/S, ...], h) -> h
    stage_params : [S, L/S, ...] leaves (``split_stages``); the rank runs
                   the stage at its coordinate on ``axis``
    x_micro      : [M, B_micro, ...] microbatches, the same on every rank
    Returns [M, B_micro, ...], the last stage's outputs summed to every
    rank of the axis.
    """
    n_stages = mesh.sizes[axis]
    M = x_micro.shape[0]
    T = M + n_stages - 1                      # fill + steady + drain
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    s = C.axis_index(mesh, axis)
    my = pytree.tree_map(lambda p: p[s], stage_params)
    h_in = torch.zeros_like(x_micro[0])
    emitted = []
    # every rank keeps what it received and what it emits in its graph, as
    # the reference's ``jnp.where`` does: the backward walks the ring's
    # reverse permutations on every rank, step for step
    for t in range(T):
        # stage 0 injects microbatch t while t < M
        inject = torch.tensor(s == 0 and t < M, device=x_micro.device)
        h_cur = torch.where(inject, x_micro[min(t, M - 1)], h_in)
        h_out = block_fn(my, h_cur)
        emitted.append(h_out)
        if t < T - 1:
            h_in = C.ppermute(h_out, mesh, axis, perm)
    # microbatch m leaves the last stage at t = m + S - 1; only that
    # stage's values are outputs, summed to every rank of the axis
    out = torch.stack(emitted[n_stages - 1:])
    last = torch.tensor(s == n_stages - 1, device=out.device)
    return C.psum(torch.where(last, out, torch.zeros_like(out)), mesh, axis)


def data_parallel(fn: Callable[[Tree, Tree], Tree], *, mesh,
                  axis: str = "data") -> Callable[[Tree, Tree], Tree]:
    """fn(params, x) -> y with every leaf of ``x`` and ``y`` batched on dim
    0, as a function of the whole batch on every rank of ``axis``: the
    rank runs ``fn`` on its B/n rows (params replicated) and the outputs
    are gathered in the order of the ranks' coordinates.  A batch that the
    axis does not divide raises ``ValueError``."""
    n = mesh.sizes[axis]

    def wrapped(params: Tree, x: Tree) -> Tree:
        B = pytree.tree_leaves(x)[0].shape[0]
        if B % n != 0:
            raise ValueError(f"batch {B} not divisible by {axis}={n} shards")
        rows = B // n
        start = C.axis_index(mesh, axis) * rows
        y = fn(params, pytree.tree_map(lambda a: a[start:start + rows], x))
        return pytree.tree_map(lambda a: C.all_gather(a, mesh, axis, 0), y)

    return wrapped


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"microbatch: batch {B} into {n_micro} microbatches")
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe schedule overhead: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
