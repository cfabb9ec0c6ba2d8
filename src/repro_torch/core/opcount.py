"""Operation counts of a program as it runs: FLOPs, bytes accessed,
transcendentals, the peak of live bytes, and a breakdown by name.

The JAX package reads these numbers off XLA (``compiled.cost_analysis()``
and ``memory_analysis()``).  The port has no compiler between the program
and the device, so ``OpCounter`` counts the program itself: a
``TorchDispatchMode`` that sees every aten op the program runs, on
``meta``, CPU and CUDA tensors alike, the backward included.  On ``meta``
tensors nothing is computed and nothing allocated, so a rank's program at
the production mesh is counted in seconds on the host
(``launch.dryrun``).

What each aten op adds:

- ``flops``: ``torch.utils.flop_counter``'s formula where it has one (the
  products: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions);
  other ops add none, as XLA counts no FLOPs for elementwise work in the
  roofline's compute term;
- ``bytes accessed``: the bytes of the op's tensor inputs and outputs,
  each counted once an op (a view, ``_unsafe_view`` and an uninitialised
  ``empty`` move none; ``copy_`` / ``fill_`` / ``zero_`` do not read the
  tensor they write).  This is the eager program's traffic if nothing
  fuses: an upper bound on what a fused program moves;
- ``transcendentals``: the elements of ``TRANSCENDENTAL``'s ops (exp,
  log, tanh, sigmoid, erf, sqrt, rsqrt, sin, cos and the ops built on
  them), the first tensor argument's count of elements.

The kernels are counted by formula, not by what runs underneath: each
entry point of ``kernels.ops`` (and the two backwards) wraps its work in
``kernel(name, ...)``, which adds the function's own FLOPs, bytes (each
operand read once, each output written once) and transcendentals and
suspends the aten count inside the call.  So a CPU run (the plain
versions), a CUDA run (the kernels) and a meta trace (empty outputs of the
kernels' shapes) of one program give the same counts.  The formulas are
the function's work, whatever implements it: ``attention_flops`` over the
q.k pairs that no mask removes, ``wkv_flops`` (``core.workload.scan_macs``)
and ``wkv_bwd_flops`` for the WKV, ``adamw_counts`` for the optimizer's
update of a leaf (elementwise, so no FLOPs, as no elementwise aten op
adds any).  Collectives run suspended as well:
their traffic is ``runtime.collectives``' record, not bytes accessed.

The peak of live bytes follows storages: a storage that an op allocates
while a counter is active is live until the storage is freed (views and
autograd's saved copies keep it alive), and ``hold`` adds storages that
exist before (a step's arguments).  Allocations inside a suspended call
count too: on the card that is the kernel's outputs and workspaces, on
``meta`` the outputs and saved tensors of the kernel's route, on the CPU
the plain version's temporaries.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.workload import SCAN, Layer, scan_macs

aten = torch.ops.aten

# ops whose elements are each a transcendental function's value
TRANSCENDENTAL = frozenset(getattr(aten, n) for n in (
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10",
    "tanh", "tanh_", "sigmoid", "sigmoid_", "erf", "erf_", "erfc", "erfinv",
    "sqrt", "sqrt_", "rsqrt", "rsqrt_", "sin", "cos", "tan", "atan2",
    "silu", "silu_", "silu_backward", "gelu", "gelu_", "gelu_backward",
    "softplus", "softplus_backward", "_softmax", "_log_softmax",
    "_log_softmax_backward_data", "logsumexp", "logaddexp", "logit"))
# ops that move no bytes: uninitialised allocations and a reshape of a
# fresh result
_FREE = frozenset(getattr(aten, n) for n in (
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view"))
# in-place ops that write their first argument without reading it
_WRITE_ONLY = frozenset(getattr(aten, n) for n in (
    "copy_", "fill_", "zero_", "uniform_", "normal_"))

_ACTIVE: list = []        # counters entered, innermost last
_suspended = 0            # > 0 inside a kernel's or a collective's call
_ignored = 0              # > 0 inside work that is not the program's


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the tensors' elements (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def tensors(tree) -> list:
    """The tensors among the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples nested)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: program()`` -> ``c.flops``,
    ``c.bytes_accessed``, ``c.transcendentals``, ``c.peak_bytes`` and
    ``c.by_name`` (name -> {"calls", "flops", "bytes accessed",
    "transcendentals"}: ``aten.mm`` ... for aten ops, the kernel's name for
    a kernel).  ``hold`` registers tensors that are live before the
    program runs (its arguments): they count in ``peak_bytes`` until
    freed, and ``held_bytes`` is their sum; ``read`` says whether the
    program read a tensor."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.by_name: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes accessed": 0,
                     "transcendentals": 0})
        self.live_bytes = 0
        self.peak_bytes = 0
        self.held_bytes = 0
        self._storages: Dict[int, int] = {}
        self._read: set = set()

    # -- storages ---------------------------------------------------------

    def _freed(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, t: torch.Tensor) -> int:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._storages:
            return 0
        n = s.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        weakref.finalize(s, self._freed, key, n)
        return n

    def hold(self, *trees) -> int:
        """Counts the storages of every tensor in ``trees`` as live from
        now on (until freed); returns the bytes added."""
        n = sum(self._track(t) for t in tensors(trees))
        self.held_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def read(self, t: torch.Tensor) -> bool:
        """Whether an op counted here took ``t``'s storage as an input."""
        return t.untyped_storage()._cdata in self._read

    # -- counts -----------------------------------------------------------

    def add(self, name: str, *, flops: int = 0, bytes_accessed: int = 0,
            transcendentals: int = 0) -> None:
        self.flops += flops
        self.bytes_accessed += bytes_accessed
        self.transcendentals += transcendentals
        rec = self.by_name[name]
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes accessed"] += bytes_accessed
        rec["transcendentals"] += transcendentals

    def kernels(self) -> Dict[str, Dict[str, int]]:
        """The breakdown's entries that are kernels (not aten ops)."""
        return {k: dict(v) for k, v in self.by_name.items()
                if not k.startswith("aten.")}

    # -- the mode ---------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _ignored:
            return out
        ins = tensors((args, kwargs))
        self._read.update(t.untyped_storage()._cdata for t in ins)
        outs = tensors(out)
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if _suspended:
            return out
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet in _FREE or func.is_view:
            moved = 0
        else:
            if packet in _WRITE_ONLY:
                ins = ins[1:]
            moved = nbytes(*ins) + nbytes(*outs)
        trans = 0
        if packet in TRANSCENDENTAL:
            first = tensors(args)
            trans = first[0].numel() if first else 0
        self.add(f"aten.{packet.__name__}", flops=flops, bytes_accessed=moved,
                 transcendentals=trans)
        return out


class kernel:
    """``with kernel(name, flops=, bytes_accessed=, transcendentals=,
    reads=):`` around a kernel's call: every active counter adds the
    function's formula under ``name`` and takes the tensors ``reads`` as
    read, whatever the route reads, and counts no aten op inside (their
    storages still count in the peak).  Free when no counter is active."""

    def __init__(self, name: str, *, flops: int, bytes_accessed: int,
                 transcendentals: int = 0, reads=()):
        self.name, self.flops = name, flops
        self.bytes_accessed, self.transcendentals = bytes_accessed, transcendentals
        self.reads = reads

    def __enter__(self):
        global _suspended
        _suspended += 1
        return self

    def __exit__(self, *exc):
        global _suspended
        _suspended -= 1
        if exc[0] is None:
            for c in _ACTIVE:
                c.add(self.name, flops=self.flops, bytes_accessed=self.bytes_accessed,
                      transcendentals=self.transcendentals)
                c._read.update(t.untyped_storage()._cdata for t in self.reads
                               if t is not None)
        return False


class suspended:
    """No counter counts the aten ops inside (a collective's copies: its
    traffic is the collectives' record); their storages still count in
    the peak."""

    def __enter__(self):
        global _suspended
        _suspended += 1
        return self

    def __exit__(self, *exc):
        global _suspended
        _suspended -= 1
        return False


class ignored:
    """Work that is not the program's (shapes worked out on meta tensors,
    ``launch.specs.cache_specs``): no counter counts its ops or their
    storages."""

    def __enter__(self):
        global _ignored
        _ignored += 1
        return self

    def __exit__(self, *exc):
        global _ignored
        _ignored -= 1
        return False


def counting() -> bool:
    """Whether a counter is active (a kernel's formula is worth working
    out)."""
    return bool(_ACTIVE)


# ---------------------------------------------------------------------------
# The kernels' formulas
# ---------------------------------------------------------------------------


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """q.k pairs that no mask removes: what the operations bound counts
    (query row i at position q_offset + i)."""
    qp = np.arange(Sq) + q_offset
    hi = np.minimum(Sk - 1, qp) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qp - window + 1) if window is not None else np.zeros(Sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int, *, causal: bool,
                    window, q_offset: int = 0, backward: bool = False) -> int:
    """The attention's FLOPs over the pairs no mask removes: q.k and p.v,
    2 D each a pair; the backward's five products (S, dP, dV, dK, dQ),
    2 D each."""
    pairs = B * H * unmasked_pairs(Sq, Sk, causal, window, q_offset)
    return (10 if backward else 4) * D * pairs


def wkv_flops(BH: int, T: int, K: int, V: int, chunk: int) -> int:
    """2 x ``core.workload.scan_macs`` of the chunked WKV at C = min(chunk,
    T)."""
    return 2 * scan_macs(Layer("wkv", SCAN, b=BH, ox=T, c=K, k=V), min(chunk, T))


def wkv_bwd_macs(BH: int, T: int, K: int, V: int, C: int) -> int:
    """Multiply-adds of the chunked WKV backward, counted as
    ``core.workload.scan_macs`` counts the forward's: per row, the reverse
    states update and the three inter-chunk products (dr from S_c, dk and
    dv from G'), 4 K V, and per pair of rows of a chunk dA, A and the
    intra-chunk dr, dk (K each) and dv (V), C (3 K + 2 V)."""
    return BH * T * (4 * K * V + C * (3 * K + 2 * V))


def wkv_bwd_flops(BH: int, T: int, K: int, V: int, chunk: int) -> int:
    return 2 * wkv_bwd_macs(BH, T, K, V, min(chunk, T))



# AdamW's floating-point operations a parameter (the clip's scale, the two
# moments, the bias corrections, eps, the decay, the rate, the update), which
# bound nothing on the card next to its bytes, and its square root
ADAMW_OPS = 16


def adamw_counts(p, g, m, v, *scalars) -> dict:
    """``kernel``'s counts of one leaf's AdamW update: p, g, m, v and the
    scalars read once, p, m and v written once (28 bytes a float32
    parameter); FLOPs 0, as the counter counts no elementwise op's
    (``ADAMW_OPS`` a parameter is the work); one square root a parameter."""
    return dict(flops=0, bytes_accessed=nbytes(p, g, m, v, *scalars) + nbytes(p, m, v),
                transcendentals=p.numel())
