"""Exhaustive interleaving explorer for the artifact claim-lock
protocol in ``search.cache``.

Models N abstract processes running ``cached_search`` on one cold key
as per-process state machines over a tiny shared state (the lock file
as an inode + pid stamp, the kernel flock table, the artifact flag),
plus a nondeterministic *crash* action that kills a process at any
program counter (dropping its flocks, leaving its files and stamps
behind — exactly what the kernel does).  Every reachable interleaving
is enumerated by BFS and checked against the protocol's safety
invariants:

  multi_store     more than one ``save_schedule`` for the key
  double_claim    two processes simultaneously own a validated claim
  foreign_unlink  a release unlinks a lock file it does not own
  lost_store      a fault-free run ends with no stored artifact
  lock_leak       a fault-free run leaks a lock file or a held flock

Two protocols are modeled.  ``"flock"`` is the current implementation
(non-blocking ``flock`` + inode re-validation + artifact re-check
under the claim): the explorer proves it safe for N=2 and N=3 with
crashes.  ``"legacy"`` is the previous create/stamp/unlink scheme,
kept as the explorer's teeth: it finds the unstamped-lock race, the
takeover-unlink ABA (two processes observing one stale lock both
"take it over", the second unlinking the first's *fresh* claim), and
the late-claim double store — each as a concrete violation trace.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# process program counters (fixed protocol)
_DONE = "done"

# stamp values: None (empty file), ("p", i) (stamped by process i),
# "dead" (planted stamp whose owner is gone — a crashed legacy writer)


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str
    trace: Tuple[str, ...]

    def __str__(self) -> str:
        return f"{self.kind}: " + " ; ".join(self.trace)


@dataclasses.dataclass
class ExploreResult:
    protocol: str
    n: int
    max_crashes: int
    states: int
    terminals: int
    violations: List[Violation]
    # terminal (stores, artifact, crashes_used) outcomes observed
    outcomes: set

    @property
    def ok(self) -> bool:
        return not self.violations


def _proc(pc="replay", fd=-1, tries=0, crashed=False, claimed=False):
    return (pc, fd, tries, crashed, claimed)


def _initial(n: int, *, artifact: bool, planted_stamp,
             crash_budget: int):
    file = (0, planted_stamp) if planted_stamp is not None else None
    next_ino = 1 if file is not None else 0
    return (file, (), bool(artifact), 0, 0, next_ino, crash_budget,
            tuple(_proc() for _ in range(n)))


def _unpack(s):
    return {"file": s[0], "locks": dict(s[1]), "artifact": s[2],
            "stores": s[3], "takeovers": s[4], "next_ino": s[5],
            "crashes_left": s[6], "procs": list(s[7])}


def _pack(d):
    return (d["file"], tuple(sorted(d["locks"].items())), d["artifact"],
            d["stores"], d["takeovers"], d["next_ino"],
            d["crashes_left"], tuple(d["procs"]))


def _stamp_alive(stamp, procs) -> bool:
    """Is the stamp's owner a live process?  A pid stamp whose owner
    crashed (or the planted ``"dead"`` pid) fails the liveness probe,
    exactly like ``os.kill(pid, 0)`` on a reaped process."""
    if stamp is None or stamp == "dead":
        return False
    return not procs[stamp[1]][3]


def _steps_flock(s, i) -> Iterable[Tuple[str, tuple]]:
    """Successor states for process i under the current protocol."""
    d = _unpack(s)
    pc, fd, tries, crashed, claimed = d["procs"][i]

    def emit(label, **changes):
        nd = _unpack(s)
        p = dict(zip(("pc", "fd", "tries", "crashed", "claimed"),
                     nd["procs"][i]))
        p.update({k: v for k, v in changes.items()
                  if k in ("pc", "fd", "tries", "crashed", "claimed")})
        nd["procs"][i] = (p["pc"], p["fd"], p["tries"], p["crashed"],
                          p["claimed"])
        for k in ("file", "locks", "artifact", "stores", "takeovers",
                  "next_ino"):
            if k in changes:
                nd[k] = changes[k]
        return (f"p{i}:{label}", _pack(nd))

    if pc == "replay":
        if d["artifact"]:
            yield emit("replay_hit", pc=_DONE)
        else:
            yield emit("replay_miss", pc="open")
    elif pc == "open":
        if d["file"] is None:
            ino = d["next_ino"]
            yield emit("open_create", pc="flock", fd=ino,
                       file=(ino, None), next_ino=ino + 1)
        else:
            yield emit("open", pc="flock", fd=d["file"][0])
    elif pc == "flock":
        if fd in d["locks"]:
            # EWOULDBLOCK: a live claimant owns the key — search and
            # return without storing (store_skipped)
            yield emit("flock_denied", pc=_DONE)
        else:
            locks = dict(d["locks"])
            locks[fd] = i
            yield emit("flock_acquire", pc="validate", locks=locks)
    elif pc == "validate":
        if d["file"] is not None and d["file"][0] == fd:
            yield emit("validate_ok", pc="read", claimed=True)
        else:
            locks = dict(d["locks"])
            locks.pop(fd, None)
            if tries + 1 >= 3:
                yield emit("validate_giveup", pc=_DONE, fd=-1,
                           tries=tries + 1, locks=locks)
            else:
                yield emit("validate_retry", pc="open", fd=-1,
                           tries=tries + 1, locks=locks)
    elif pc == "read":
        stamp = d["file"][1]
        if stamp is None:
            yield emit("stamp_empty", pc="stamp")
        elif _stamp_alive(stamp, d["procs"]):
            # live stamper without a flock: modeled as fresh — back off
            locks = dict(d["locks"])
            locks.pop(fd, None)
            yield emit("stamp_live_backoff", pc=_DONE, fd=-1,
                       claimed=False, locks=locks)
        else:
            yield emit("takeover", pc="stamp",
                       takeovers=d["takeovers"] + 1)
    elif pc == "stamp":
        yield emit("stamp_self", pc="search", file=(fd, ("p", i)))
    elif pc == "search":
        yield emit("search", pc="check")
    elif pc == "check":
        if d["artifact"]:
            yield emit("store_skip", pc="release")
        else:
            yield emit("store", pc="release", artifact=True,
                       stores=d["stores"] + 1)
    elif pc == "release":
        locks = dict(d["locks"])
        locks.pop(fd, None)
        label = "release"
        if d["file"] is None or d["file"][0] != fd:
            label = "release_foreign"          # flagged as a violation
        yield emit(label, pc=_DONE, fd=-1, claimed=False, file=None,
                   locks=locks)


def _steps_legacy(s, i) -> Iterable[Tuple[str, tuple]]:
    """Successors under the old create/stamp/unlink protocol.  The pc
    ``fd`` slot holds the ino of the lock file this process created;
    ``tries`` counts the claim loop iterations (the old code looped
    twice)."""
    d = _unpack(s)
    pc, own, tries, crashed, claimed = d["procs"][i]

    def emit(label, **changes):
        nd = _unpack(s)
        p = dict(zip(("pc", "fd", "tries", "crashed", "claimed"),
                     nd["procs"][i]))
        p.update({k: v for k, v in changes.items()
                  if k in ("pc", "fd", "tries", "crashed", "claimed")})
        nd["procs"][i] = (p["pc"], p["fd"], p["tries"], p["crashed"],
                          p["claimed"])
        for k in ("file", "locks", "artifact", "stores", "takeovers",
                  "next_ino"):
            if k in changes:
                nd[k] = changes[k]
        return (f"p{i}:{label}", _pack(nd))

    if pc == "replay":
        if d["artifact"]:
            yield emit("replay_hit", pc=_DONE)
        else:
            yield emit("replay_miss", pc="try")
    elif pc == "try":
        if d["file"] is None:
            ino = d["next_ino"]
            # O_CREAT|O_EXCL succeeded; the pid stamp is a SECOND step
            yield emit("create_excl", pc="stamp", fd=ino,
                       file=(ino, None), next_ino=ino + 1)
        else:
            yield emit("read_lock", pc="judge")
    elif pc == "stamp":
        if d["file"] is not None and d["file"][0] == own:
            yield emit("stamp_self", pc="search", claimed=True,
                       file=(own, ("p", i)))
        else:
            # our freshly created file was unlinked before we stamped:
            # the old code still returned True (it had no way to tell)
            yield emit("stamp_lost", pc="search", claimed=True)
    elif pc == "judge":
        stamp = d["file"][1] if d["file"] is not None else None
        if d["file"] is None:
            yield emit("holder_gone_retry", pc="loop")
        elif stamp is not None and _stamp_alive(stamp, d["procs"]):
            yield emit("live_holder_backoff", pc=_DONE)
        else:
            # empty stamp reads as pid 0 => "dead"; stale/dead stamps
            # are broken.  The unlink is a separate step on the NAME —
            # whatever file is there by then gets removed.
            yield emit("takeover_decide", pc="unlink",
                       takeovers=d["takeovers"] + 1)
    elif pc == "unlink":
        label = "takeover_unlink"
        if d["file"] is not None and d["file"][1] is not None \
                and d["file"][1] not in (None, "dead") \
                and _stamp_alive(d["file"][1], d["procs"]):
            label = "takeover_unlink_fresh"    # the ABA: a live claim dies
        yield emit(label, pc="loop", file=None)
    elif pc == "loop":
        if tries + 1 >= 2:
            yield emit("loop_exhausted", pc=_DONE, tries=tries + 1)
        else:
            yield emit("loop_retry", pc="try", tries=tries + 1)
    elif pc == "search":
        yield emit("search", pc="store")
    elif pc == "store":
        # the old code stored unconditionally under a claim
        yield emit("store", pc="release", artifact=True,
                   stores=d["stores"] + 1)
    elif pc == "release":
        yield emit("release", pc=_DONE, claimed=False, file=None)


def explore(n: int = 2, *, max_crashes: int = 0,
            planted_stamp=None, artifact: bool = False,
            protocol: str = "flock",
            max_violations: int = 16) -> ExploreResult:
    """BFS the full interleaving space and collect invariant
    violations (each with a minimal-length action trace)."""
    steps = {"flock": _steps_flock, "legacy": _steps_legacy}[protocol]
    init = _initial(n, artifact=artifact, planted_stamp=planted_stamp,
                    crash_budget=max_crashes)
    parent: Dict[tuple, Optional[Tuple[tuple, str]]] = {init: None}
    queue = deque([init])
    violations: List[Violation] = []
    flagged = set()
    terminals = 0
    outcomes = set()

    def trace_of(s, extra: Optional[str] = None) -> Tuple[str, ...]:
        out = []
        cur = s
        while parent[cur] is not None:
            prev, label = parent[cur]
            out.append(label)
            cur = prev
        out.reverse()
        if extra:
            out.append(extra)
        return tuple(out)

    def flag(kind, s, extra=None):
        if kind in flagged or len(violations) >= max_violations:
            return
        flagged.add(kind)
        violations.append(Violation(kind, trace_of(s, extra)))

    while queue:
        s = queue.popleft()
        d = _unpack(s)
        if d["stores"] > 1:
            flag("multi_store", s)
        if sum(1 for p in d["procs"] if p[4] and not p[3]) > 1:
            flag("double_claim", s)
        successors = []
        for i, p in enumerate(d["procs"]):
            if p[0] == _DONE or p[3]:
                continue
            for label, ns in steps(s, i):
                if label.endswith("release_foreign") \
                        or label.endswith("takeover_unlink_fresh"):
                    flag("foreign_unlink", s, label)
                successors.append((label, ns))
            if d["crashes_left"] > 0:
                nd = _unpack(s)
                nd["crashes_left"] -= 1
                nd["locks"] = {k: v for k, v in nd["locks"].items()
                               if v != i}
                pp = nd["procs"][i]
                nd["procs"][i] = (pp[0], pp[1], pp[2], True, False)
                successors.append((f"p{i}:crash", _pack(nd)))
        if not successors:
            terminals += 1
            crashes_used = max_crashes - d["crashes_left"]
            outcomes.add((d["stores"], d["artifact"], crashes_used))
            fault_free = crashes_used == 0
            if fault_free and not artifact and d["stores"] == 0:
                flag("lost_store", s)
            if fault_free and (d["locks"] or d["file"] is not None):
                flag("lock_leak", s)
            continue
        for label, ns in successors:
            if ns not in parent:
                parent[ns] = (s, label)
                queue.append(ns)

    return ExploreResult(protocol=protocol, n=n,
                         max_crashes=max_crashes, states=len(parent),
                         terminals=terminals, violations=violations,
                         outcomes=outcomes)


def verify_protocol(max_n: int = 3) -> List[ExploreResult]:
    """The acceptance sweep: the flock protocol over N=2..max_n with 0,
    1, and N-1 crashes, from a clean start and from a crashed-claimant
    stamp.  Every result must be violation-free."""
    out = []
    for n in range(2, max_n + 1):
        for crashes in {0, 1, n - 1}:
            out.append(explore(n, max_crashes=crashes))
            out.append(explore(n, max_crashes=crashes,
                               planted_stamp="dead"))
    return out
