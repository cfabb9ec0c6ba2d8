"""Whole steps captured as CUDA graphs and replayed: the port's counterpart
of ``jax.jit`` for a step (``repro/launch/serve.py`` jits its prefill and
its decode step with ``donate_argnums=(1,)``).

``captured(fn)`` returns a callable with ``fn``'s signature.  The first
call at a new signature of its tensor arguments (their shapes, dtypes and
device, in their tree of dicts, lists and tuples) captures ``fn`` into a
``torch.cuda.CUDAGraph``, as ``jit`` traces a new shape; every later call
at that signature copies the arguments into the graph's static buffers
and replays it.  Between the host and the card that leaves a few copies
and one graph launch a step, however many kernels the step runs.

- Parameters are bound into ``fn`` (``functools.partial(step, params)``)
  and read by address: the graph sees whatever those tensors hold at
  replay, and nothing copies them.
- An argument that already is the graph's static buffer (the cache a
  donated step returned) is not copied.
- Outputs are returned as fresh tensors, cloned out of the graph's pool,
  so a caller that keeps every step's logits gets what the eager step
  gives.  The exception is an output that is an argument's static buffer
  (``donating``): that buffer itself is returned, and the next replay
  overwrites it, as a donated buffer is consumed.
- Before capture ``fn`` runs ``WARMUP`` times on a side stream, so that no
  kernel's lazy module load and no wrapper's first-launch opt-in to its
  shared memory (``csrc/*.cu``, one static flag per instance and device)
  happens inside the capture.  Those eager runs launch the kernels and
  tick their launch counters; the capture ticks them once more; a replay
  ticks none.
- Warm-up, capture and replay all run under ``torch.inference_mode()``:
  static buffers made outside it could not be updated in place inside it.
- Graphs of one ``captured`` share one memory pool; ``pool=`` shares it
  wider (a model's prefill and decode step).  The graphs of one pool must
  be replayed one at a time on one stream, which a request loop does.

No fallback: CPU tensors raise ``ValueError`` (the CPU has no graphs; the
caller picks the eager step by device, as ``kernels.ops`` routes by
device), and a capture that fails raises.  A sharded serving step is
captured where its mesh has no axis of more than one rank, and runs eager
where a collective crosses ranks (``capturable``).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

# eager runs before a capture (the recipe of torch.cuda.graphs: at least two)
WARMUP = 2


class _Graph:
    """One captured signature: the graph, its static argument leaves and
    the output tree it writes."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static: List[Any],
                 out_leaves: List[Any], out_spec, donated: List[bool]):
        self.graph = graph
        self.static = static
        self.out_leaves = out_leaves
        self.out_spec = out_spec
        self.donated = donated


def _signature(leaves: List[Any], spec) -> Tuple:
    """The key a graph is kept under: the tree's structure, and each leaf's
    shape, dtype and device (a tensor) or its value (anything else, which
    the capture bakes in)."""
    return (repr(spec),) + tuple(
        ("tensor", tuple(x.shape), x.dtype, x.device)
        if isinstance(x, torch.Tensor) else ("value", x) for x in leaves)


class Captured:
    """``fn`` captured once per signature and replayed (module docstring)."""

    def __init__(self, fn: Callable, *, pool=None):
        functools.update_wrapper(self, fn, updated=())
        self.fn = fn
        self.pool = pool
        self.graphs: Dict[Tuple, _Graph] = {}
        # host seconds of each capture (warm-up and capture, synchronised),
        # in the order they were made
        self.capture_s: List[float] = []

    def __call__(self, *args, **kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not tensors:
            raise ValueError("captured: no tensor argument to capture over")
        for x in tensors:
            if not x.is_cuda:
                raise ValueError(
                    f"captured: an argument is on {x.device}; CUDA graphs "
                    f"capture CUDA tensors only (run the eager step there)")
        device = tensors[0].device
        with torch.inference_mode(), torch.cuda.device(device):
            key = _signature(leaves, spec)
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = self._capture(leaves, spec)
            for src, dst in zip(leaves, g.static):
                if isinstance(src, torch.Tensor) and src is not dst:
                    dst.copy_(src)
            g.graph.replay()
            out = [x.clone() if isinstance(x, torch.Tensor) and not d else x
                   for x, d in zip(g.out_leaves, g.donated)]
        return pytree.tree_unflatten(out, g.out_spec)

    def _capture(self, leaves: List[Any], spec) -> _Graph:
        t0 = time.perf_counter()
        static = [x.clone(memory_format=torch.contiguous_format)
                  if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = pytree.tree_unflatten(static, spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*args, **kwargs)
        torch.cuda.current_stream().wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.capture_s.append(time.perf_counter() - t0)
        out_leaves, out_spec = pytree.tree_flatten(out)
        ids = {id(x) for x in static if isinstance(x, torch.Tensor)}
        donated = [isinstance(x, torch.Tensor) and id(x) in ids
                   for x in out_leaves]
        return _Graph(graph, static, out_leaves, out_spec, donated)


def captured(fn: Callable, *, pool=None) -> Captured:
    """``fn`` as a callable that captures a CUDA graph at each new signature
    of its tensor arguments and replays it (module docstring).  ``pool``: a
    ``torch.cuda.graph_pool_handle()`` to share with other graphs of the
    same model; by default the graphs of this callable share their own."""
    return Captured(fn, pool=pool)


def capturable(mesh) -> bool:
    """Whether a step on ``mesh`` (None: one device) is captured: on a
    mesh where no axis has more than one rank every collective is its
    input and the step is the one-device step, captured as it is.  Where a
    collective crosses ranks the step runs eager: gloo stages every one
    through the host, which a graph cannot hold."""
    return mesh is None or all(n == 1 for n in mesh.shape)


def donating(step: Callable, argnum: int) -> Callable:
    """``step`` with argument ``argnum`` donated, as ``jax.jit(step,
    donate_argnums=(argnum,))``: ``step`` returns a tuple whose last element
    is the new value of that argument (the decode steps' cache); its leaves
    are copied into the argument's tensors, and the argument itself is
    returned in its place.  The cache then lives in one set of buffers
    across steps.  Works on any device; under ``captured`` the copies are
    inside the graph, so a decode loop copies no cache on the host side."""

    @functools.wraps(step)
    def donated(*args, **kwargs):
        out = step(*args, **kwargs)
        old = args[argnum]
        dst, dst_spec = pytree.tree_flatten(old)
        src, src_spec = pytree.tree_flatten(out[-1])
        if repr(dst_spec) != repr(src_spec):
            raise ValueError(f"donating: step returned {src_spec} for "
                             f"argument {argnum}, which is {dst_spec}")
        for d, s in zip(dst, src):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(
                    f"donating: argument {argnum} has a leaf {tuple(d.shape)} "
                    f"{d.dtype}, the step returned {tuple(s.shape)} {s.dtype}")
            d.copy_(s)
        return (*out[:-1], old)

    return donated
