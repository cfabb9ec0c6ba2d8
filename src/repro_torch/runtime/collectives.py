"""Collectives over one axis of a ``launch.mesh.Mesh``: the port's
counterparts of ``lax.psum``, ``lax.pmean``, ``lax.all_gather``,
``lax.ppermute`` and ``lax.axis_index`` inside a ``shard_map`` body, over
the axis's process group.

Where a gradient flows through them they are ``torch.autograd.Function``s
whose backward is the forward's adjoint: ``psum``'s is ``psum``,
``all_gather``'s the sum of the gradients over the axis cut to this rank's
slice, ``ppermute``'s the reverse permutation, ``chain``'s sends the
reverse way.  So the gradient each rank
computes is that of the SUM over the ranks of each rank's loss, its share
of it: the gradient of the ranks' mean loss is the mean of the ranks'
gradients over every mesh axis (``mesh_mean``).  Ranks that hold the same
value (a replicated result) count it once each, so the mean over them
counts it once: the truth the sharded code is held to is autograd of the
plain one-device function.  ``all_gather`` over a dp axis is the FSDP
gather: its adjoint is the reduce-scatter of the ranks' partial gradients
(an all-reduce, then the rank's narrow: gloo has no reduce-scatter).

Tensor parallelism over an axis (Megatron's split) needs the conjugate
pairs instead, because there every rank of the axis holds the same loss
and the same cotangent of a replicated value, not a share of them:
``copy_to`` (identity forward, sum backward) where a replicated value
enters a column-parallel product, whose ranks each give only their
columns' part of its gradient; ``reduce_from`` (sum forward, identity
backward) at a row-parallel product's partial output; ``gather_from``
(all-gather forward, the rank's slice backward) where a split value is
used whole by replicated code.  ``pmax`` is a max over the axis with no
gradient (the logsumexp's shift).

``chain`` runs a step on each rank of an axis in coordinate order, each
rank's starting from the state the one before it left (a recurrence over
a sequence split across the axis): a send to the next rank and a receive
from the one before, each an autograd node.  Both ends of a message must
be nodes that the backward runs, or the one that waits for the gradient
would wait for ever: the send returns the step's output through itself
(a tensor the loss reads), and the receive hangs from a tensor of the
rank's own graph (``anchor``, its gradient zero).

A collective over an axis of one rank is its input: nothing is sent (a
(1, 1) mesh's step is the one-device step, bit for bit).

Under gloo a CUDA tensor goes through an explicit copy to the host for
every collective (gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only, and stages those through the host itself), so that
one path, the one the CPU runs, carries them all; ``host_staged_bytes``
counts the bytes of those copies, both ways.  Under NCCL tensors stay on
the card.

On ``meta`` tensors (the dry-run's trace of a rank's program over
``launch.mesh.abstract_mesh``) every collective returns a meta tensor of
its result's shape and touches no process group: nothing is sent and no
world exists.

Every collective that crosses ranks, real or meta, adds to ``record`` under
the names XLA gives the collective the program asks for (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``): its count, its result's bytes and its operand's,
as ``core.hloanalysis.CollectiveStats`` holds them.  The FSDP gather's
adjoint is recorded as the ``reduce-scatter`` it is (its operand the
unreduced gradient), though gloo runs it as an all-reduce and the rank's
narrow; ``chain``'s send is a ``collective-permute`` whose operand is the
message, its receive one whose result is.  Their copies count no bytes
accessed under a ``core.opcount.OpCounter``: the traffic is the record's.

The serving steps under 'cp' move what the last rank of an axis holds at
the end of a sequence split over it: ``from_last`` hands a value to every
rank (recorded as the ``all-reduce`` of the others' zeros it runs), and
``scatter_from_last`` hands rank r only block r of it, one
``collective-permute`` of a block for each rank before the last (every
rank's record counts all of them, as each device's program holds every
permute of the partitioned HLO).  Neither carries a gradient.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import opcount

host_staged_bytes = 0
# kind -> [count, result bytes, operand bytes] since the last reset_record()
record: Dict[str, List[int]] = {}


def reset_record() -> None:
    record.clear()


def _record(kind: str, result: int, operand: int) -> None:
    entry = record.setdefault(kind, [0, 0, 0])
    entry[0] += 1
    entry[1] += result
    entry[2] += operand


def _staged(x: torch.Tensor, mesh) -> bool:
    return x.is_cuda and mesh.backend == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    global host_staged_bytes
    host_staged_bytes += x.numel() * x.element_size()
    return x.cpu()


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    global host_staged_bytes
    host_staged_bytes += x.numel() * x.element_size()
    return x.to(device)


def _send(x: torch.Tensor, mesh, axis: str, dst: int) -> None:
    _record("collective-permute", 0, opcount.nbytes(x))
    if x.is_meta:
        return
    with opcount.suspended():
        src = x.detach().contiguous()
        if _staged(src, mesh):
            src = _to_host(src)
        dist.send(src, mesh.axis_ranks[axis][dst])


def _recv(meta, mesh, axis: str, src: int) -> torch.Tensor:
    """A tensor of ``meta`` = (shape, dtype, device) from coordinate
    ``src``."""
    shape, dtype, device = meta
    staged = device.type == "cuda" and mesh.backend == "gloo"
    with opcount.suspended():
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        _record("collective-permute", opcount.nbytes(buf), 0)
        if device.type == "meta":
            return buf
        dist.recv(buf, mesh.axis_ranks[axis][src])
        return _to_device(buf, device) if staged else buf


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh.coords[axis]


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=None,
                kind: str = "all-reduce") -> torch.Tensor:
    """The sum (``op``: another ``dist.ReduceOp``) of ``x`` over the axis;
    recorded as ``kind`` where it is not None."""
    if kind is not None:
        _record(kind, opcount.nbytes(x), opcount.nbytes(x))
    with opcount.suspended():
        if x.is_meta:
            return torch.empty_like(x, memory_format=torch.contiguous_format)
        staged = _staged(x, mesh)
        out = (_to_host(x.detach().contiguous()) if staged
               else x.detach().clone(memory_format=torch.contiguous_format))
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=mesh.groups[axis])
        return _to_device(out, x.device) if staged else out


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.sizes[axis]
    _record("all-gather", n * opcount.nbytes(x), opcount.nbytes(x))
    with opcount.suspended():
        if x.is_meta:
            shape = list(x.shape)
            shape[dim] *= n
            return x.new_empty(shape)
        src = x.detach().contiguous()
        if _staged(src, mesh):
            src = _to_host(src)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.groups[axis])
        out = torch.cat(parts, dim)
        return _to_device(out, x.device) if _staged(x, mesh) else out


def _permute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Sends this rank's ``x`` to the coordinate ``perm`` maps it to and
    returns what arrives; zeros where nothing is sent to this rank."""
    if mesh.sizes[axis] > 1:
        _record("collective-permute", opcount.nbytes(x), opcount.nbytes(x))
    with opcount.suspended():
        if x.is_meta:
            return torch.empty_like(x, memory_format=torch.contiguous_format)
        me = mesh.coords[axis]
        ranks = mesh.axis_ranks[axis]
        src = x.detach().contiguous()
        out = torch.zeros_like(src)
        staged = _staged(src, mesh)
        send = src if not staged else _to_host(src)
        recv = out if not staged else torch.zeros_like(send)
        ops: List[dist.P2POp] = []
        for s, d in perm:
            if s == me and d == me:
                recv.copy_(send)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, send, ranks[d]))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, recv, ranks[s]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return _to_device(recv, x.device) if staged else recv


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        me = ctx.mesh.coords[ctx.axis]
        _record("reduce-scatter", opcount.nbytes(g) // ctx.mesh.sizes[ctx.axis],
                opcount.nbytes(g))
        total = _all_reduce(g, ctx.mesh, ctx.axis, kind=None)
        return total.narrow(ctx.dim, me * ctx.n, ctx.n), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.mesh, ctx.axis, back), None, None, None


class _SendThrough(torch.autograd.Function):
    """Sends ``x`` to coordinate ``dst`` and returns ``carrier``; the
    backward receives x's gradient from ``dst``."""

    @staticmethod
    def forward(ctx, x, carrier, mesh, axis, dst):
        ctx.mesh, ctx.axis, ctx.dst = mesh, axis, dst
        ctx.meta = (x.shape, x.dtype, x.device)
        _send(x, mesh, axis, dst)
        return carrier.view_as(carrier)

    @staticmethod
    def backward(ctx, g):
        dx = _recv(ctx.meta, ctx.mesh, ctx.axis, ctx.dst)
        return dx, g, None, None, None


class _RecvHung(torch.autograd.Function):
    """A tensor like ``like`` received from coordinate ``src``; the backward
    sends its gradient back to ``src`` (``anchor`` gets none)."""

    @staticmethod
    def forward(ctx, anchor, like, mesh, axis, src):
        ctx.mesh, ctx.axis, ctx.src = mesh, axis, src
        return _recv((like.shape, like.dtype, like.device), mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.mesh, ctx.axis, ctx.src)
        return None, None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.n, ctx.me = dim, x.shape[dim], mesh.coords[axis]
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.n, ctx.n), None, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank of it."""
    if mesh.sizes[axis] == 1:
        return x
    return _PSum.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` itself (a value every rank of the axis holds whole); its
    gradient the sum of the ranks' gradients over the axis."""
    if mesh.sizes[axis] == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the axis; its gradient each
    rank's own (the cotangent of a replicated value, the same on every
    rank)."""
    if mesh.sizes[axis] == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` for replicated code; its
    gradient the rank's slice of the (replicated) cotangent."""
    if mesh.sizes[axis] == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``x`` over the axis, detached."""
    if mesh.sizes[axis] == 1:
        return x.detach()
    return _all_reduce(x, mesh, axis, op=dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``x`` over the axis, on every rank of it."""
    return psum(x, mesh, axis) / mesh.sizes[axis]


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the order of their
    coordinate (``lax.all_gather(..., tiled=True)``)."""
    if mesh.sizes[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: each (source, destination) pair of coordinates
    sends the source's ``x`` to the destination; a rank that receives
    nothing gets zeros."""
    return _PPermute.apply(x, mesh, axis, tuple(perm))


def chain(step, mesh, axis: str, like: torch.Tensor, anchor: torch.Tensor):
    """``step(state) -> (out, state_out)`` run by the ranks of ``axis`` one
    after another in coordinate order, rank i's ``state`` rank i - 1's
    ``state_out`` (None on rank 0, as on an axis of one rank), received
    into a tensor like ``like``.  Returns this rank's (out, state_out).
    Under autograd the states' gradients go back the other way, rank i + 1
    to rank i: ``anchor`` is a tensor of this rank's graph that leads to
    the leaves asked for (its gradient is zero), so that the backward runs
    the receive, and the send goes through ``out``, which the loss must
    read.  A rank's step starts when the one before it has sent: the ranks
    run in turn."""
    me, n = mesh.coords[axis], mesh.sizes[axis]
    state = None
    if me > 0:
        state = _RecvHung.apply(anchor, like, mesh, axis, me - 1)
    out, last = step(state)
    if me < n - 1:
        out = _SendThrough.apply(last, out, mesh, axis, me + 1)
    return out, last


def from_last(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The last coordinate's ``x`` on every rank of the axis: the others'
    zeroed and summed over it (an ``all-reduce``).  No gradient."""
    n = mesh.sizes[axis]
    if n == 1:
        return x
    if mesh.coords[axis] != n - 1:
        with opcount.suspended():
            x = torch.zeros_like(x)
    return _all_reduce(x, mesh, axis)


def scatter_from_last(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Block r of n along ``dim`` of the last coordinate's ``x`` on rank r
    of the axis: the last rank keeps its own block and sends rank r < n - 1
    its block r, one ``collective-permute`` of a block each (recorded on
    every rank), each rank receiving only its own.  No gradient."""
    n, me = mesh.sizes[axis], mesh.coords[axis]
    if n == 1:
        return x
    dim = dim % x.dim()
    step = x.shape[dim] // n
    with opcount.suspended():
        block = x.narrow(dim, me * step, step)
        for _ in range(n - 1):
            _record("collective-permute", opcount.nbytes(block), opcount.nbytes(block))
        if x.is_meta:
            return block.contiguous()
        staged = _staged(x, mesh)
        ranks = mesh.axis_ranks[axis]
        if me == n - 1:
            sends = [x.narrow(dim, r * step, step).contiguous() for r in range(n - 1)]
            sends = [_to_host(b) if staged else b for b in sends]
            ops = [dist.P2POp(dist.isend, b, ranks[r]) for r, b in enumerate(sends)]
            out = block.contiguous()
        else:
            recv = torch.empty(block.shape, dtype=x.dtype,
                               device="cpu" if staged else x.device)
            ops = [dist.P2POp(dist.irecv, recv, ranks[n - 1])]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if me != n - 1:
            out = _to_device(recv, x.device) if staged else recv
    return out


def mesh_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over every mesh axis, outermost first."""
    for a in mesh.axis_names:
        x = pmean(x, mesh, a)
    return x
