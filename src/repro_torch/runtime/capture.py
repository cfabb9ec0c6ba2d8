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

``captured_train_step(step)`` is the counterpart of the reference
launcher's ``jit(train_step, donate_argnums=(0, 1))`` for a train step
(``runtime.steps.build_train_step``: (params, opt_state, batch) ->
(params, opt_state, metrics), the parameters and moments updated in
place).  ``Captured`` cannot take one: it runs under inference mode, which
forbids autograd, and warms up on clones, which would advance the
optimizer on real state.  The train step's wrapper differs so:

- grad mode, no inference mode;
- the parameter and moment trees and the count of its first call are
  donated: adopted as they are, never cloned, the graph's static buffers
  from then on, and returned by every call.  The step's new count (a new
  tensor, ``count + 1``) is written back into the donated count, inside
  the graph once captured, so that each replay reads the count the one
  before left (the schedule's rate and the bias corrections move on).  A
  call with other tensors (a checkpoint restored into fresh ones) has
  them copied into the donated buffers first;
- each call is exactly one step: the first ``WARMUP`` are the real steps
  0 and 1, run eagerly on a side stream (every kernel's module loaded and
  opted into its shared memory outside the capture); then the card is
  synchronised and the allocator's cache emptied, so that the eager
  steps' cached blocks do not sit beside the graph's pool; the next call
  captures (which records and runs nothing) and replays; later calls copy
  the batch into its static buffers and replay.  The metrics come back
  cloned out of the pool;
- the launch counters tick at the eager steps and once at the capture,
  never at a replay; so does anything else the step does in Python (a
  collectives record, ``sharding.gathered_bytes``): read them per capture.
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


class DonatedTrainStep:
    """A train step with its state donated, on any device (module
    docstring): the first call's parameter and moment trees and count are
    adopted and returned by every call, another call's tensors copied into
    them, the step's new count written into the donated one."""

    def __init__(self, step: Callable):
        functools.update_wrapper(self, step, updated=())
        self.step = step
        self.params = self.opt = None

    def __call__(self, params, opt_state, batch):
        self.donate(params, opt_state)
        params, opt, metrics = self.step(self.params, self.opt, batch)
        kept = pytree.tree_leaves((self.params, self.opt.m, self.opt.v))
        got = pytree.tree_leaves((params, opt.m, opt.v))
        if len(got) != len(kept) or any(a is not b for a, b in zip(got, kept)):
            raise ValueError("donated train step: the step returned new parameter or "
                             "moment tensors; it must update them in place")
        with torch.no_grad():
            self.opt.count.copy_(opt.count)
        return self.params, self.opt, metrics

    def donate(self, params, opt_state) -> None:
        """Adopts the first call's trees; copies another call's tensors into
        them where they are not the donated ones."""
        if self.params is None:
            self.params, self.opt = params, opt_state
            return
        src, src_spec = pytree.tree_flatten((params, opt_state))
        dst, dst_spec = pytree.tree_flatten((self.params, self.opt))
        if repr(src_spec) != repr(dst_spec):
            raise ValueError("donated train step: the parameters or the optimizer "
                             "state are not the donated trees' structure")
        with torch.no_grad():
            for s, d in zip(src, dst):
                if s is d:
                    continue
                if s.shape != d.shape or s.dtype != d.dtype:
                    raise ValueError(
                        f"donated train step: a leaf {tuple(s.shape)} {s.dtype} for "
                        f"the donated {tuple(d.shape)} {d.dtype}")
                d.copy_(s)


class CapturedTrainStep:
    """A train step captured once and replayed with its state donated
    (module docstring).  ``capture_s``: the capture's host seconds (after
    the warm-up steps, synchronised); ``pool_mib``: MiB the allocator
    reserved for the graph's pool; ``calls`` and ``replays``."""

    def __init__(self, step: Callable):
        functools.update_wrapper(self, step, updated=())
        self.donated = DonatedTrainStep(step)
        self.graph: Any = None
        self.batch_static: Any = None
        self.batch_key: Any = None
        self.metrics: Any = None
        self.capture_s: Any = None
        self.pool_mib: Any = None
        self.calls = 0
        self.replays = 0

    def __call__(self, params, opt_state, batch):
        for x in pytree.tree_leaves((params, opt_state, batch)):
            if isinstance(x, torch.Tensor) and not x.is_cuda:
                raise ValueError(
                    f"captured_train_step: a tensor is on {x.device}; CUDA graphs "
                    f"capture CUDA tensors only (run the eager step there)")
        d = self.donated
        with torch.cuda.device(pytree.tree_leaves(opt_state)[0].device):
            d.donate(params, opt_state)
            if self.calls < WARMUP:
                metrics = self._eager(batch)
            else:
                if self.graph is None:
                    self._capture(batch)
                else:
                    leaves, spec = pytree.tree_flatten(batch)
                    if _signature(leaves, spec) != self.batch_key:
                        raise ValueError(
                            "captured_train_step: a batch of another signature than "
                            "the captured one; build and capture another step for it")
                    for src, dst in zip(leaves, self.batch_static):
                        if src is not dst:
                            dst.copy_(src)
                self.graph.replay()
                self.replays += 1
                metrics = {k: v.clone() for k, v in self.metrics.items()}
            self.calls += 1
        return d.params, d.opt, metrics

    def _eager(self, batch):
        d = self.donated
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, _, metrics = d(d.params, d.opt, batch)
        torch.cuda.current_stream().wait_stream(side)
        metrics = {k: v.clone() for k, v in metrics.items()}
        torch.cuda.synchronize()
        return metrics

    def _capture(self, batch) -> None:
        t0 = time.perf_counter()
        d = self.donated
        leaves, spec = pytree.tree_flatten(batch)
        self.batch_key = _signature(leaves, spec)
        self.batch_static = [x.clone(memory_format=torch.contiguous_format)
                             if isinstance(x, torch.Tensor) else x for x in leaves]
        static = pytree.tree_unflatten(self.batch_static, spec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, _, metrics = d(d.params, d.opt, static)
        torch.cuda.synchronize()
        self.graph, self.metrics = graph, metrics
        self.capture_s = time.perf_counter() - t0
        self.pool_mib = (torch.cuda.memory_reserved() - before) / 2 ** 20


def captured_train_step(step: Callable) -> CapturedTrainStep:
    """``step`` (``build_train_step``'s) as the reference launcher's
    ``jit(step, donate_argnums=(0, 1))``: one CUDA graph of the whole step,
    the parameters, moments and count donated (module docstring).  Only on
    the card and where ``capturable`` holds for the step's mesh (a sharded
    step's ``mesh``); raises ``ValueError`` on any other."""
    mesh = getattr(step, "mesh", None)
    if not capturable(mesh):
        raise ValueError(f"captured_train_step: the step's mesh {mesh.sizes} has an "
                         f"axis of more than one rank (a collective crosses ranks); "
                         f"run it eager")
    return CapturedTrainStep(step)


def donated_train_step(step: Callable) -> DonatedTrainStep:
    """``step`` (``build_train_step``'s) with its parameter and moment trees
    and count donated, as ``jax.jit(step, donate_argnums=(0, 1))`` donates
    them, eagerly on any device: the part of ``captured_train_step`` that
    is no graph (module docstring)."""
    return DonatedTrainStep(step)
