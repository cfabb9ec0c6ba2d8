"""Fault injection for the serving stack: deterministic chaos.

Edge serving only counts if schedules keep flowing when the stack
misbehaves — a crashed search worker, a half-written artifact, a claim
lock left behind by a killed process, an artifact from an older engine,
a search that suddenly takes seconds.  This module injects exactly
those faults, *deterministically* (one ``ChaosPlan`` seed reproduces a
whole session bit-for-bit), and the tests then assert the
graceful-degradation ladder in ``ServeStore.request`` serves every
request anyway.

Two injection surfaces:

  file-level   — ``truncate_artifact`` / ``set_artifact_version`` /
                 ``plant_stale_lock`` sabotage the content-addressed
                 cache directory directly, the way a crashed writer, a
                 partial copy, or an old deployment actually would;
  search-level — an ambient ``ChaosMonkey`` (installed with
                 ``monkey.active()``) arms per-request faults that fire
                 inside the store's retry envelope via
                 ``on_search_attempt()``: ``worker_crash`` raises an
                 ``InjectedFault``, ``slow_search`` sleeps.  With no
                 active monkey the hook is a no-op attribute load, so
                 the fault-free serving path stays bit-identical.

``chaos_session`` is the harness: N lookups against a warmed store with
faults drawn per request from the plan's probabilities; it returns a
``ChaosReport`` and the acceptance invariant is simply
``report.all_served`` — no request ever sees ``None``.  Every injected
fault is counted as ``serve.chaos.<fault>`` via ``repro_torch.obs``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.search.cache import artifact_name

# the injectable fault classes, in the order the CLI reports them
FAULTS = ("worker_crash", "corrupt_artifact", "stale_lock",
          "version_mismatch", "slow_search")


class InjectedFault(RuntimeError):
    """Raised at an injection point standing in for a real failure (a
    search worker OOM-killed mid-DP, a wedged subprocess).  The first
    arg is the fault class, so the exception round-trips a process-pool
    pickle boundary intact."""

    @property
    def fault(self) -> str:
        return str(self.args[0]) if self.args else "fault"


class DeadlineExceeded(RuntimeError):
    """A cold search (with its retries) overran the caller's deadline
    budget — the degradation ladder takes over."""


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Per-request fault probabilities (0..1) plus fault knobs.  One
    seed makes the whole session — which faults fire on which request —
    fully deterministic."""
    seed: int = 0
    worker_crash: float = 0.0
    corrupt_artifact: float = 0.0
    stale_lock: float = 0.0
    version_mismatch: float = 0.0
    slow_search: float = 0.0
    slow_s: float = 0.01          # injected delay per slow search
    crash_attempts: int = 1       # consecutive search attempts that die

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "ChaosPlan":
        """CLI form: ``"worker_crash=0.3,stale_lock=0.2"`` (``all=P``
        arms every fault class at probability P)."""
        kw: Dict[str, object] = {"seed": seed}
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            name, _, val = tok.partition("=")
            v = float(val) if val else 1.0
            if name == "all":
                for f in FAULTS:
                    kw[f] = v
            elif name in FAULTS or name in ("slow_s", "crash_attempts"):
                kw[name] = int(v) if name == "crash_attempts" else v
            else:
                raise ValueError(
                    f"unknown chaos fault {name!r}; choose from "
                    f"{FAULTS + ('slow_s', 'crash_attempts', 'all')}")
        return cls(**kw)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# file-level sabotage (what a crashed writer / old deployment leaves)
# ---------------------------------------------------------------------------


def artifact_path(store, workload: str, batch: int = 1) -> Path:
    """The on-disk artifact a ``(workload, batch)`` request replays."""
    name, _, key = store.resolve(workload, batch)
    return Path(store.cache_dir) / artifact_name(name, key)


def truncate_artifact(path: Path, frac: float = 0.5) -> None:
    """Corrupt one artifact the way a torn write / partial copy does:
    keep only the leading ``frac`` of its bytes (invalid JSON)."""
    path = Path(path)
    raw = path.read_bytes()
    path.write_bytes(raw[:max(1, int(len(raw) * frac))])


def set_artifact_version(path: Path, version: int) -> None:
    """Rewrite the artifact's embedded search version (valid JSON, stale
    engine — the replay must version-reject, never apply it)."""
    path = Path(path)
    doc = json.loads(path.read_text())
    doc["version"] = version
    path.write_text(json.dumps(doc))


def _dead_pid() -> int:
    """A pid that is definitely not alive (for planting stale claims)."""
    pid = 4_000_000            # above the default Linux pid_max
    while pid > 2:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return pid
        except OSError:
            return pid
        pid -= 7919
    return 4_000_000


def plant_stale_lock(path: Path, *, pid: Optional[int] = None,
                     age_s: float = 1e6) -> Path:
    """Leave the claim lock a killed writer would: ``<path>.lock``
    holding a dead pid (or a live one aged past the staleness window —
    set ``age_s`` and a small ``stale_s`` on the store to exercise the
    age-based takeover with ``pid=os.getpid()``)."""
    lock = Path(f"{path}.lock")
    lock.parent.mkdir(parents=True, exist_ok=True)
    lock.write_text(str(_dead_pid() if pid is None else pid))
    old = time.time() - age_s
    os.utime(lock, (old, old))
    return lock


# ---------------------------------------------------------------------------
# the ambient monkey: search-level faults inside the retry envelope
# ---------------------------------------------------------------------------

_ACTIVE: Optional["ChaosMonkey"] = None


def current() -> Optional["ChaosMonkey"]:
    """The active monkey, or None when chaos is off."""
    return _ACTIVE


def on_search_attempt() -> None:
    """Injection point the store's retry envelope calls before every
    cold-search attempt.  No-op (one global load) when chaos is off."""
    m = _ACTIVE
    if m is not None:
        m.search_attempt()


class ChaosMonkey:
    """Draws faults from a ``ChaosPlan`` and applies them: file-level
    sabotage up front (``sabotage``), search-level faults when armed
    (``arm_search_faults`` -> fired by ``on_search_attempt``)."""

    def __init__(self, plan: ChaosPlan) -> None:
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self._crash_left = 0
        self._slow_left = 0

    @contextlib.contextmanager
    def active(self) -> Iterator["ChaosMonkey"]:
        """Install this monkey as the ambient injection target."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def should(self, fault: str) -> bool:
        """One Bernoulli draw for ``fault`` (always drawn, so the
        decision stream — and with it the whole session — depends only
        on the seed, not on which faults are enabled)."""
        p = float(getattr(self.plan, fault))
        return self.rng.random() < p

    # -- search-level -------------------------------------------------

    def arm_search_faults(self, *, crash: bool, slow: bool) -> None:
        if crash:
            self._crash_left = max(1, self.plan.crash_attempts)
        if slow:
            self._slow_left = 1

    def search_attempt(self) -> None:
        """Fire armed faults: slow first (a slow search still runs),
        then crash (the attempt dies)."""
        if self._slow_left > 0:
            self._slow_left -= 1
            obs.count("serve.chaos.slow_search")
            time.sleep(self.plan.slow_s)
        if self._crash_left > 0:
            self._crash_left -= 1
            obs.count("serve.chaos.worker_crash")
            raise InjectedFault("worker_crash")

    # -- file-level + per-request orchestration -----------------------

    def sabotage(self, store, workload: str, batch: int) -> List[str]:
        """Decide and apply this request's faults against ``store``.
        File faults need the request out of the memory tier (a corrupt
        disk artifact behind a warm memory entry is invisible — exactly
        the point of the tier), so sabotaged entries are evicted the
        way a process restart would.  Returns the fault names applied.
        """
        applied: List[str] = []
        path = artifact_path(store, workload, batch)
        if self.should("corrupt_artifact") and path.exists():
            store.evict(workload, batch)
            truncate_artifact(path)
            obs.count("serve.chaos.corrupt_artifact")
            applied.append("corrupt_artifact")
        # version rewrite needs parseable JSON — skipped when this same
        # request just tore the file (truncation is the stronger fault;
        # the Bernoulli draw still happens, keeping the stream seeded)
        if self.should("version_mismatch") and path.exists() \
                and "corrupt_artifact" not in applied:
            store.evict(workload, batch)
            set_artifact_version(path, version=1)
            obs.count("serve.chaos.version_mismatch")
            applied.append("version_mismatch")
        if self.should("stale_lock"):
            store.evict(workload, batch)
            path.unlink(missing_ok=True)       # force the claim path
            plant_stale_lock(path)
            obs.count("serve.chaos.stale_lock")
            applied.append("stale_lock")
        crash = self.should("worker_crash")
        slow = self.should("slow_search")
        if crash or slow:
            # search faults only fire on a cold search: push the
            # request all the way down to the DP
            store.evict(workload, batch)
            path.unlink(missing_ok=True)
            self.arm_search_faults(crash=crash, slow=slow)
            applied.extend(f for f, on in
                           (("worker_crash", crash),
                            ("slow_search", slow)) if on)
        return applied


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One request of a chaos session."""
    index: int
    batch: int
    faults: Tuple[str, ...]        # injected before/during this request
    outcome: str                   # LookupResult.outcome
    degraded: bool


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """What a ``chaos_session`` did and how the ladder answered."""
    workload: str
    requests: int
    served: int                    # lookups that returned a schedule
    degraded: int                  # served off rung 3/4 of the ladder
    faults: Dict[str, int]         # fault class -> times injected
    outcomes: Dict[str, int]       # LookupResult.outcome -> count
    events: Tuple[ChaosEvent, ...]

    @property
    def all_served(self) -> bool:
        """The acceptance invariant: every request got a schedule."""
        return self.served == self.requests


def chaos_session(store, workload: str, *,
                  n_requests: int = 24,
                  plan: ChaosPlan = ChaosPlan(),
                  batches: Sequence[int] = (1, 4)) -> ChaosReport:
    """Hammer ``store`` with ``n_requests`` lookups while injecting
    faults per ``plan``.  The store must already be warmed over
    ``batches`` (the session sabotages existing artifacts).  Asserting
    on the report is the caller's job; the session itself only
    guarantees determinism and bookkeeping."""
    monkey = ChaosMonkey(plan)
    faults: Dict[str, int] = {f: 0 for f in FAULTS}
    outcomes: Dict[str, int] = {}
    events: List[ChaosEvent] = []
    served = degraded = 0
    with monkey.active(), obs.span("serve.chaos", workload=workload,
                                   requests=n_requests):
        for i in range(n_requests):
            b = monkey.rng.choice(list(batches))
            applied = monkey.sabotage(store, workload, b)
            for f in applied:
                faults[f] += 1
            res = store.request(workload, b)
            ok = res.schedule is not None
            served += ok
            degraded += res.degraded
            outcomes[res.outcome] = outcomes.get(res.outcome, 0) + 1
            events.append(ChaosEvent(index=i, batch=b,
                                     faults=tuple(applied),
                                     outcome=res.outcome,
                                     degraded=res.degraded))
            obs.event("serve.chaos.request", index=i, batch=b,
                      faults=list(applied), outcome=res.outcome,
                      degraded=res.degraded)
    obs.count("serve.chaos.requests", n_requests)
    obs.count("serve.chaos.served", served)
    return ChaosReport(workload=workload, requests=n_requests,
                       served=served, degraded=degraded, faults=faults,
                       outcomes=outcomes, events=tuple(events))
