"""Hierarchical span tracer + typed counters/gauges for the search stack.

A ``Tracer`` records a tree of *spans* (named wall-time intervals with
attributes), integer *counters*, float *gauges*, and the flat
``phase_s`` wall-time table the legacy ``search.perf.PerfRecorder``
surface reads.  One tracer covers one search run, one DSE sweep, or one
CLI invocation; exporters (``repro_torch.obs.exporters``) turn it into a
Chrome-trace JSON (loadable in ``chrome://tracing`` / Perfetto) or
BENCH rows.

Instrumentation sites never hold a tracer: they call the *ambient*
module-level hooks (``obs.span`` / ``obs.count`` / ``obs.gauge`` /
``obs.event``), which route to the currently active tracer installed by
``tracing()`` — and degrade to no-ops (a shared ``nullcontext``, an
early return) when none is active, so an uninstrumented run pays one
global load + ``None`` check per hook and the searched schedules stay
bit-identical (pinned against the goldens in ``tests/test_obs.py``).

Thread safety: each thread keeps its own open-span stack
(``threading.local``), so spans opened on different threads nest
independently; finished root spans append to the shared tree under a
lock.  Process safety: a tracer itself is not picklable (it holds the
lock) — pool workers run their own tracer and ship ``to_tables()``
(plain dicts) back over the pickle boundary; the caller folds them in
with ``merge_tables``, rebasing the workers' relative timestamps onto
its own clock and giving each worker tree a distinct track id.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional


class Span:
    """One named wall-time interval.  ``t0`` is seconds since the owning
    tracer's epoch (relative, so span trees are portable across
    processes); ``dur_s`` is 0.0 for instant events."""

    __slots__ = ("name", "t0", "dur_s", "attrs", "children", "tid")

    def __init__(self, name: str, t0: float = 0.0, dur_s: float = 0.0,
                 attrs: Optional[Dict[str, object]] = None,
                 children: Optional[List["Span"]] = None,
                 tid: int = 0) -> None:
        self.name = name
        self.t0 = t0
        self.dur_s = dur_s
        self.attrs = attrs if attrs is not None else {}
        self.children = children if children is not None else []
        self.tid = tid

    def to_json(self) -> Dict[str, object]:
        return {"name": self.name, "t0": self.t0, "dur_s": self.dur_s,
                "attrs": self.attrs, "tid": self.tid,
                "children": [c.to_json() for c in self.children]}

    @classmethod
    def from_json(cls, doc: Dict[str, object]) -> "Span":
        return cls(name=doc["name"], t0=doc["t0"], dur_s=doc["dur_s"],
                   attrs=dict(doc.get("attrs", {})),
                   children=[cls.from_json(c)
                             for c in doc.get("children", [])],
                   tid=int(doc.get("tid", 0)))

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:  # debugging aid only
        return (f"Span({self.name!r}, t0={self.t0:.6f}, "
                f"dur_s={self.dur_s:.6f}, children={len(self.children)})")


class _SpanCtx:
    """Context half of ``Tracer.span``: pushes the (already attached)
    span on the calling thread's stack, pops and stamps the duration on
    exit."""

    __slots__ = ("_t", "_sp")

    def __init__(self, tracer: "Tracer", sp: Span) -> None:
        self._t = tracer
        self._sp = sp

    def __enter__(self) -> Span:
        self._t._stack().append(self._sp)
        return self._sp

    def __exit__(self, *exc) -> None:
        t, sp = self._t, self._sp
        t._stack().pop()
        sp.dur_s = (time.perf_counter() - t.epoch) - sp.t0


class Tracer:
    """Span tree + counters/gauges + the legacy ``phase_s`` table for
    one traced run.  See the module docstring for the threading /
    process model."""

    def __init__(self) -> None:
        self.epoch = time.perf_counter()
        self.phase_s: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.roots: List[Span] = []
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._ntid = 0

    # -- clock --------------------------------------------------------

    def now(self) -> float:
        """Seconds since this tracer's epoch."""
        return time.perf_counter() - self.epoch

    # -- spans --------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _tid(self) -> int:
        t = getattr(self._tls, "tid", None)
        if t is None:
            with self._lock:
                t = self._tls.tid = self._ntid
                self._ntid += 1
        return t

    def _alloc_tid(self) -> int:
        with self._lock:
            t = self._ntid
            self._ntid += 1
        return t

    def _attach(self, sp: Span) -> None:
        st = self._stack()
        if st:
            st[-1].children.append(sp)
        else:
            with self._lock:
                self.roots.append(sp)

    def span(self, name: str, **attrs) -> "_SpanCtx":
        """Open a nested span (use as a context manager); attributes
        must be JSON-serializable.  Returns a lightweight handwritten
        context object instead of a ``contextlib`` generator — spans
        sit on the traced hot path."""
        sp = Span(name, t0=self.now(), attrs=attrs, tid=self._tid())
        self._attach(sp)
        return _SpanCtx(self, sp)

    def event(self, name: str, **attrs) -> Span:
        """Instant (zero-duration) span at the current nesting point.
        Body inlined (no ``now``/``_tid``/``_attach`` calls): events are
        the densest instrumentation (one per layer mapping, one per
        fusion cut), so this is the traced hot path."""
        tls = self._tls
        tid = getattr(tls, "tid", None)
        if tid is None:
            tid = self._tid()
        sp = Span(name, t0=time.perf_counter() - self.epoch,
                  attrs=attrs, tid=tid)
        st = getattr(tls, "stack", None)
        if st:
            st[-1].children.append(sp)
        else:
            if st is None:
                tls.stack = []
            with self._lock:
                self.roots.append(sp)
        return sp

    # -- counters / gauges --------------------------------------------

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def gauge(self, key: str, value: float) -> None:
        self.gauges[key] = float(value)

    # -- process-boundary serialization -------------------------------

    def to_tables(self) -> Dict[str, object]:
        """Plain-dict snapshot for the pickle/JSON boundary: phase
        times, counters, gauges, and the span forest with timestamps
        relative to this tracer's epoch."""
        return {"phase_s": dict(self.phase_s),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "spans": [r.to_json() for r in self.roots]}

    def merge_tables(self, tables: Dict[str, object], *,
                     offset: float = 0.0,
                     label: str = "") -> None:
        """Fold another tracer's ``to_tables()`` snapshot into this one.

        Counter values add, gauges last-write-win, phase times
        accumulate (same fold as ``PerfRecorder.merge``).  Span trees
        are rebased by ``offset`` (the caller-clock time the donor
        tracer started, typically captured with ``now()`` at worker
        launch) and attached at the current nesting point — under the
        open ``dse`` span during a sweep — on a fresh track id so
        concurrent workers render side by side."""
        for k, v in tables.get("phase_s", {}).items():
            self.phase_s[k] = self.phase_s.get(k, 0.0) + v
        for k, v in tables.get("counters", {}).items():
            self.count(k, v)
        for k, v in tables.get("gauges", {}).items():
            self.gauge(k, v)
        for doc in tables.get("spans", []):
            root = Span.from_json(doc)
            tid = self._alloc_tid()
            for sp in root.walk():
                sp.t0 += offset
                sp.tid = tid
            if label:
                root.attrs.setdefault("worker", label)
            self._attach(root)

    def span_count(self) -> int:
        return sum(1 for r in self.roots for _ in r.walk())


# ---------------------------------------------------------------------------
# Ambient active tracer + no-op hooks
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None
_NULL = contextlib.nullcontext()


def current() -> Optional[Tracer]:
    """The active tracer, or None when tracing is off."""
    return _ACTIVE


def activate(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the ambient target (None switches tracing
    off).  Prefer the ``tracing()`` context manager, which restores the
    previous tracer on exit."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Activate a tracer for the dynamic extent of the block (a fresh
    one when none is given); restores the previously active tracer on
    exit, so traced regions nest."""
    t = tracer if tracer is not None else Tracer()
    prev = _ACTIVE
    activate(t)
    try:
        yield t
    finally:
        activate(prev)


def span(name: str, **attrs):
    """Ambient span: nests under the active tracer, or a shared no-op
    context when tracing is off."""
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.span(name, **attrs)


def count(key: str, n: int = 1) -> None:
    # counters are the most frequent hook (several per computed layer),
    # so the table update is inlined rather than calling Tracer.count
    t = _ACTIVE
    if t is not None:
        c = t.counters
        c[key] = c.get(key, 0) + n


def gauge(key: str, value: float) -> None:
    t = _ACTIVE
    if t is not None:
        t.gauge(key, value)


def event(name: str, **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)
