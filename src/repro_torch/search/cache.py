"""JSON schedule artifacts + content-addressed search cache.

A schedule is a pure function of (workload layer list, HWSpec, search
version); ``schedule_key`` hashes that triple so repeated CLI /
benchmark invocations reuse the artifact instead of re-running the DP.
Artifacts are plain JSON (one file per schedule) so they can be diffed,
committed, or consumed by external tooling.

Writes are atomic: ``save_schedule`` lands the document in a
same-directory temp file and ``os.replace``s it into place, so a
reader — including another ``cached_search`` racing on the same key —
observes either no artifact or a complete one, never a truncated JSON
(which would replay as ``cache.corrupt``).  Under write contention a
per-key ``flock``-held claim file additionally serializes the store
itself: of N processes missing on one key, exactly one performs the
store — in *every* interleaving, not just the common ones (the claim
protocol is exhaustively model-checked by ``repro_torch.check.races``); the
others still search (they need the result) but skip the redundant
write (``cache.store_skipped``).
"""
from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import List, Optional

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.core.workload import Layer

# bump when the search space / cost accounting changes so stale cached
# schedules are never replayed against a newer engine
# v2: divisor + imperfect-factor tile enumeration, ragged-edge cost
#     accounting, tiled cost rows, ragged-aware lowering
# v3: N-level MemoryHierarchy in HWSpec (hashed via the nested level
#     list), per-operand loop placements, per-level group residence
# v4: placement-aware per-level traffic rows in the headline costing;
#     cache keys hash the ordered layer-signature list + the HWSpec
#     content signature (stable across cosmetic layer renames /
#     annotation changes, which never affect the searched schedule)
# v5: factored spatial mappings with row/col replication (mappings may
#     carry the per-axis ((dim, factor), ...) form); ``spatial_mode``
#     is a search dimension hashed into the key
# v6: chunked-recurrence (SCAN) op class — scan layers carry a searched
#     chunk length + state residence level in ``tiles`` and a state
#     placement entry, and the fusion DP prices carry-state traffic;
#     schedules for scan-free workloads change only in this version tag
SEARCH_VERSION = 6


def schedule_key(layers: List[Layer], hw: HWSpec,
                 tile_mode: str = "full",
                 spatial_mode: str = "factored") -> str:
    """Content hash identifying one search problem: the ordered list of
    canonical layer signatures (op/dims only — layer *names* and graph
    annotations never reach a scheduler decision, so a cosmetic rename
    keeps the key), the HWSpec content signature, and the tile- and
    spatial-mapspace modes (search dimensions: an ablation schedule
    must never be replayed as a full-enumeration result)."""
    blob = json.dumps(
        {"v": SEARCH_VERSION, "hw": hw.signature,
         "layers": [l.signature for l in layers],
         "tile_mode": tile_mode, "spatial_mode": spatial_mode},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_schedule(schedule, path: Path) -> Path:
    """Write a Schedule (dataclass) as a JSON artifact, atomically.

    The document goes to a same-directory ``*.tmp`` file first and is
    ``os.replace``d into place, so a concurrent reader (or a parallel
    ``--jobs`` sweep / second serving worker racing on the same key)
    never observes a truncated artifact: the path either does not exist
    yet or holds complete JSON.  A writer crashing inside the window
    leaves at most a stray temp file, which no loader ever matches."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = json.dumps(dataclasses.asdict(schedule), indent=1,
                      sort_keys=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent,
                               prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# a claim older than this is stale even if its pid looks alive (pid
# reuse): the claiming search should take milliseconds, not minutes.
_CLAIM_STALE_S = 120.0


# flock fds held by claims this process owns, keyed by lock path; the
# fd must outlive the claim (closing it drops the kernel lock)
_CLAIM_FDS: dict = {}


def _claim_store(path: Path) -> bool:
    """Try to claim the store of one artifact key.

    The claim is an exclusive non-blocking ``flock`` on ``<path>.lock``
    plus a pid stamp inside it.  ``flock`` makes the protocol safe by
    construction where the old create/stamp/unlink scheme was not: the
    kernel releases a crashed claimant's lock instantly (no stale
    window to wait out), acquisition and ownership are one atomic step
    (no unstamped-lock window a reader can misread as dead), and a
    taken-over lock file cannot be unlinked out from under a *fresh*
    claimant by a second taker racing the same stale observation — the
    dead inode is detected by re-validating ``fstat`` vs ``stat`` after
    acquiring, and the loser simply retries on the new file.  The
    interleaving space of this protocol is exhaustively model-checked
    by ``repro_torch.check.races``.

    Returns True when this process owns the store (and must
    ``_release_store`` afterwards), False when another live claimant
    holds the key.  A pid stamp found *without* a held flock means the
    stamper crashed (the kernel dropped its lock), or the stamp was
    planted by an older-protocol writer: it is honored only while the
    pid is alive and the stamp younger than ``_CLAIM_STALE_S``, else
    taken over (``cache.lock_takeover``)."""
    lock = Path(f"{path}.lock")
    lock.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(3):
        fd = os.open(lock, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False        # a live claimant holds the key
        try:
            disk_ino = os.stat(lock).st_ino
        except OSError:
            disk_ino = None     # released + unlinked under us: retry
        if disk_ino is None or os.fstat(fd).st_ino != disk_ino:
            os.close(fd)        # we locked a dead inode; drop + retry
            continue
        try:
            raw = os.pread(fd, 64, 0).decode("ascii", "replace").strip()
        except OSError:
            raw = ""
        if raw:
            # a stamp with no live flock: crashed claimant or a
            # legacy/planted lock file.  Honor it only while fresh.
            try:
                pid = int(raw)
            except ValueError:
                pid = 0
            age = time.time() - os.fstat(fd).st_mtime
            alive = False
            if pid > 0:
                try:
                    os.kill(pid, 0)
                    alive = True
                except (OSError, PermissionError):
                    alive = False
            if alive and age < _CLAIM_STALE_S:
                os.close(fd)    # leave the stamp untouched
                return False
            obs.count("cache.lock_takeover")
            obs.event("cache.lock_takeover", path=str(lock), pid=pid,
                      age_s=age, alive=alive)
        try:
            os.ftruncate(fd, 0)
            os.pwrite(fd, str(os.getpid()).encode(), 0)
        except OSError:
            pass                # the flock, not the stamp, is the claim
        _CLAIM_FDS[str(lock)] = fd
        return True
    return False


def _release_store(path: Path) -> None:
    """Release a held claim: unlink the lock file *first* (so a rival
    that already opened it fails inode re-validation instead of locking
    an orphan), then close the fd, dropping the flock."""
    lock = f"{path}.lock"
    fd = _CLAIM_FDS.pop(lock, None)
    try:
        os.unlink(lock)
    except OSError:
        pass
    if fd is not None:
        try:
            os.close(fd)
        except OSError:
            pass


def _load(path: Path):
    """Load one artifact, reporting *why* a replay failed instead of
    just None: returns ``(schedule, outcome)`` with outcome one of
    "ok", "unreadable" (I/O or JSON error), "version" (stale search
    version), "corrupt" (well-formed JSON that does not reconstruct)."""
    from repro_torch.core.dataflow import as_mapping
    from repro_torch.search.auto import Schedule
    try:
        raw = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None, "unreadable"
    if raw.get("version") != SEARCH_VERSION:
        return None, "version"
    try:
        return Schedule(
            version=raw["version"], workload=raw["workload"],
            key=raw["key"], hw=raw["hw"],
            mappings={k: as_mapping(v)
                      for k, v in raw["mappings"].items()},
            orders={k: tuple(v) for k, v in raw["orders"].items()},
            fused_nonlinear=tuple(raw["fused_nonlinear"]),
            groups=tuple(tuple(g) for g in raw["groups"]),
            edges=tuple(tuple(e) for e in raw["edges"]),
            tiles=raw["tiles"], lowered=raw["lowered"], cost=raw["cost"],
            fixed_wiring=raw.get("fixed_wiring", False),
            tile_mode=raw.get("tile_mode", "full"),
            spatial_mode=raw.get("spatial_mode", "factored"),
            placements={k: dict(v) for k, v in
                        raw.get("placements", {}).items()}), "ok"
    except (KeyError, TypeError, ValueError):
        # ValueError: a corrupt mapping value (malformed factored axis /
        # non-numeric factor) surfaced by as_mapping — same contract as
        # any other unreadable artifact: None, caller re-searches
        return None, "corrupt"


def load_schedule(path: Path) -> Optional["object"]:
    """Load a schedule artifact back.  Returns a Schedule, or None if the
    file is unreadable / from a different search version (use ``_load``
    / ``cached_search`` when the failure reason matters)."""
    return _load(path)[0]


def _remap_layer_names(sched, layers: List[Layer]):
    """Align a replayed schedule's name-keyed fields to the request's
    layer names.

    ``schedule_key`` hashes content signatures, not names, so a cache
    hit after a cosmetic rename is expected — but the artifact's
    mappings/orders/placements/tiles/lowered dicts still carry the OLD
    names, which would silently fail to apply.  The key match guarantees
    the ordered shape list is identical, so the artifact's chain (its
    group tuples tile the chain in order) maps positionally onto the
    request's names.  Returns the remapped Schedule, or None when the
    artifact's name list does not tile the chain or the positional
    pairing is ambiguous (corrupt artifact — caller re-searches).

    Duplicate names need care: every remapped field except the group
    tuples is *keyed by name*, so a name is only remappable when the
    positional pairing is a consistent function.  An artifact name
    appearing at two positions that pair with two *different* request
    names (or two artifact names collapsing onto one request name)
    cannot be applied unambiguously — ``dict(zip(old, new))`` would
    silently keep the last pairing and mis-remap mappings / orders /
    tiles — so the remap is rejected instead."""
    import dataclasses as _dc
    old = [n for g in sched.groups for n in g]
    new = [l.name for l in layers]
    if old == new:
        return sched
    if len(old) != len(new):
        return None
    m: dict = {}
    for o, n in zip(old, new):
        if m.setdefault(o, n) != n:
            return None         # one artifact name -> two request names
    if len(set(m.values())) != len(m):
        return None             # two artifact names -> one request name

    def _join_key(joined: str) -> str:
        return " + ".join(m.get(p, p) for p in joined.split(" + "))

    try:
        return _dc.replace(
            sched,
            mappings={m[k]: v for k, v in sched.mappings.items()},
            orders={m[k]: v for k, v in sched.orders.items()},
            placements={m[k]: v for k, v in sched.placements.items()},
            fused_nonlinear=tuple(m[n] for n in sched.fused_nonlinear),
            groups=tuple(tuple(m[n] for n in g) for g in sched.groups),
            tiles={m[k]: v for k, v in sched.tiles.items()},
            lowered={_join_key(k): v for k, v in sched.lowered.items()})
    except KeyError:        # name outside the chain: corrupt artifact
        return None


def try_replay(path: Path, layers: List[Layer], key: str, *,
               workload: str = "custom"):
    """Attempt to replay one artifact against a request: load, verify
    the embedded key, and name-remap onto the request's layers.

    Returns ``(schedule, outcome)`` — ``(Schedule, "hit")`` on success,
    else ``(None, why)`` with ``why`` one of ``"absent"`` (no file —
    nothing counted), ``"version"`` (``cache.version_reject``), or
    ``"corrupt"`` (``cache.corrupt``: unreadable / non-reconstructing /
    key-mismatched / ambiguously named).  Emits the counters and
    ``cache.replay`` events of ``cached_search``'s replay half."""
    path = Path(path)
    if not path.exists():
        return None, "absent"
    sched, why = _load(path)
    if sched is not None and sched.key != key:
        # filename/key disagreement inside the artifact body
        sched, why = None, "corrupt"
    if sched is not None:
        remapped = _remap_layer_names(sched, layers)
        if remapped is None:
            why = "corrupt"        # names do not tile the chain
        else:
            renamed = remapped is not sched
            if renamed:
                obs.count("cache.rename_remap")
            obs.count("cache.hit")
            obs.event("cache.replay", outcome="hit", workload=workload,
                      key=key, path=str(path), renamed=renamed)
            return remapped, "hit"
    if why == "version":
        obs.count("cache.version_reject")
    else:                          # "unreadable" | "corrupt"
        why = "corrupt"
        obs.count("cache.corrupt")
    obs.event("cache.replay", outcome=why, workload=workload,
              key=key, path=str(path))
    return None, why


def _replayable(path: Path, layers: List[Layer], key: str) -> bool:
    """Quiet probe (no counters): does ``path`` hold a valid artifact
    for this request?  Used by a claimant that won the store *after*
    another writer already landed a good artifact — re-storing would
    break the exactly-one-store invariant for no benefit — while a
    corrupt / stale / mis-named artifact still gets repaired."""
    sched, why = _load(path)
    return (why == "ok" and sched.key == key
            and _remap_layer_names(sched, layers) is not None)


def cached_search(layers: List[Layer], hw: Optional[HWSpec] = None, *,
                  workload: str = "custom",
                  cache_dir: Optional[Path] = None,
                  refresh: bool = False,
                  tile_mode: str = "full",
                  spatial_mode: str = "factored",
                  verify: bool = False):
    """Run (or replay) the auto-scheduler through the artifact cache.
    Replayed artifacts are name-remapped onto the request's layers (the
    content-hashed key is rename-stable by design).  ``tile_mode`` and
    ``spatial_mode`` are search dimensions and thread into both the key
    and the search, so an ablation-mode request never replays (or
    stores) a full-enumeration artifact.

    Every replay outcome is reported through ``repro_torch.obs`` (no-ops when
    no tracer is active) as ``cache.*`` counters + ``cache.replay``
    events: ``hit`` (plus ``rename_remap`` when the artifact needed
    positional renaming), ``version_reject`` (stale SEARCH_VERSION),
    ``corrupt`` (unreadable / non-reconstructing / key-mismatched /
    non-tiling / ambiguously-named artifact), and ``miss`` ->
    ``store`` when the search runs — instead of silently falling back
    to a re-search.

    Concurrency: artifact writes are atomic (``save_schedule``), and
    of N processes missing on the same key at once exactly one claims
    the store via a per-key lock file; the rest search and return
    without writing (``store_skipped``), so a hammered cache dir sees
    one ``store`` per key and zero corrupt replays.  The claim is
    released in a ``finally`` — a claimant that raises between claim
    and store (a crashed search, an injected fault) never leaks the
    lock file; a claim that *was* leaked by a killed process is broken
    after ``_CLAIM_STALE_S`` seconds (``cache.lock_takeover``).

    Artifacts are named ``<workload>-hopper-<key>.json``: the key is
    the same content hash as the JAX package's, but the ``lowered``
    launch parameters are this package's Hopper ones, so the two
    packages must never replay each other's files.

    ``verify=True`` runs the independent static checker
    (``repro_torch.check``, with the Hopper launch lint) over every
    replayed artifact before returning it (``check.pass`` /
    ``check.fail`` counters): a schedule that fails verification is
    treated as a miss, re-searched and stored again instead of being
    served.  Fault-free replays are bit-identical with or without the
    flag — the checker only reads."""
    from repro_torch.search.auto import auto_schedule
    hw = hw or HWSpec()
    if cache_dir is None:
        return auto_schedule(layers, hw, workload=workload,
                             tile_mode=tile_mode,
                             spatial_mode=spatial_mode)
    key = schedule_key(layers, hw, tile_mode=tile_mode,
                       spatial_mode=spatial_mode)
    path = Path(cache_dir) / f"{workload}-hopper-{key}.json"
    verify_failed = False
    if not refresh:
        sched, _why = try_replay(path, layers, key, workload=workload)
        if sched is not None:
            if not verify:
                return sched
            from repro_torch.check import verify_schedule
            if not verify_schedule(layers, sched, source="replay"):
                return sched
            # loadable but statically invalid: fall through to the
            # miss path and force the overwrite under the claim
            verify_failed = True
            obs.event("cache.replay", outcome="verify_fail",
                      workload=workload, key=key, path=str(path))
    obs.count("cache.miss")
    obs.event("cache.replay", outcome="miss", workload=workload, key=key,
              refresh=refresh)
    # claim BEFORE the search so concurrent missers resolve the single
    # writer up front; ``refresh`` is an explicit operator override and
    # always stores (atomic replace makes the last writer win safely)
    claimed = _claim_store(path)
    try:
        sched = auto_schedule(layers, hw, workload=workload,
                              tile_mode=tile_mode,
                              spatial_mode=spatial_mode)
        # a claim won late (after the first writer stored and released)
        # must not store again: exactly-one-store is unconditional, not
        # a matter of racing luck.  A bad on-disk artifact (corrupt /
        # stale version / mis-named) is still repaired.
        if refresh or (claimed and (verify_failed or
                                    not _replayable(path, layers, key))):
            save_schedule(sched, path)
            obs.count("cache.store")
        else:
            obs.count("cache.store_skipped")
    finally:
        if claimed:
            _release_store(path)
    return sched
