"""CLI: warm the serve store and serve schedule lookups from it.

    # pre-search batch {1,4,16,64} schedules for one arch into the store
    PYTHONPATH=src python -m repro_torch.serve --warm --arch edgenext-s \
        --cache-dir /tmp/serve-cache --jobs 4

    # a serving request against the warmed store (fresh process: the
    # lookup replays the artifact — cache.hit, never the DP)
    PYTHONPATH=src python -m repro_torch.serve --arch edgenext-s --lookup 4 \
        --cache-dir /tmp/serve-cache

    # the batch-policy table: latency-vs-batch curve + per-rate picks
    PYTHONPATH=src python -m repro_torch.serve --arch edgenext-s \
        --rates 2,15,60 --devices 4 --cache-dir /tmp/serve-cache

    # the simulated request loop: measured fill wait vs (b-1)/(2λ)
    PYTHONPATH=src python -m repro_torch.serve --arch edgenext-s --loop \
        --rates 2,15,60 --requests 2000 --cache-dir /tmp/serve-cache

    # a deterministic chaos session: inject every fault class, assert
    # the degradation ladder served every request anyway
    PYTHONPATH=src python -m repro_torch.serve --arch edgenext-s \
        --chaos all=0.3 --requests 24 --cache-dir /tmp/serve-cache

Rows print as ``name,value,note`` CSV; counters from the lookup path
print as ``serve.cache.*`` so a smoke run can assert hit/miss outcomes
directly, and chaos/loop runs
print their ``serve.degrade.*`` / ``serve.retry.*`` / ``serve.chaos.*``
/ ``serve.loop.*`` counters the same way.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

from repro_torch import obs
from repro_torch.core.costmodel import HWSpec
from repro_torch.serve.batcher import co_search
from repro_torch.serve.policy import distinct_batches, parse_rates, rate_table
from repro_torch.serve.store import BATCH_LEVELS, ServeStore

_COUNTER_ORDER = ("hit", "miss", "store", "store_skipped", "rename_remap",
                  "version_reject", "corrupt")


def _counter_rows(prefix: str, counters) -> None:
    for name in _COUNTER_ORDER:
        print(f"{prefix}.cache.{name},{counters.get(f'cache.{name}', 0)},")
    mem = counters.get("serve.store.mem_hit", 0)
    if mem:
        print(f"{prefix}.mem_hit,{mem},served from the in-process layer")


def _robustness_rows(counters) -> None:
    """The serving-robustness counter families, zero-filled so smoke
    greps always find the row."""
    for key in ("serve.retry.attempt", "serve.retry.failure",
                "serve.retry.recovered", "serve.retry.deadline_exceeded",
                "serve.degrade.search_failed",
                "serve.degrade.nearest_batch", "serve.degrade.heuristic",
                "cache.lock_takeover"):
        print(f"{key},{counters.get(key, 0)},")
    from repro_torch.serve.chaos import FAULTS
    for fault in FAULTS:
        key = f"serve.chaos.{fault}"
        if key in counters:
            print(f"{key},{counters[key]},injected")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.serve", description=__doc__)
    ap.add_argument("--arch", action="append", default=None,
                    metavar="WORKLOAD",
                    help="registered workload to serve (repeatable; "
                         "default: edgenext-s)")
    ap.add_argument("--cache-dir", type=Path, default=None,
                    help="shared artifact store directory (default: a "
                         "fresh temp dir, printed — pass a path to "
                         "reuse the store across invocations)")
    ap.add_argument("--warm", action="store_true",
                    help="pre-search the (arch x batch) grid into the "
                         "store")
    ap.add_argument("--batches", default=None, metavar="B,B,...",
                    help="co-searched batch levels (default 1,4,16,64)")
    ap.add_argument("--jobs", type=int, default=0, metavar="N",
                    help="process-pool fan-out for --warm cold searches")
    ap.add_argument("--lookup", type=int, default=None, metavar="BATCH",
                    help="serve one (arch, batch) request and print its "
                         "cache counters + wall time")
    ap.add_argument("--rates", default=None, metavar="RPS,RPS,...",
                    help="print the latency-vs-batch curve and the "
                         "policy's batch pick at each arrival rate")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel mesh width available to the "
                         "policy (batch b served as b/devices shards)")
    ap.add_argument("--dispatch-ms", type=float, default=20.0,
                    help="per-batch launch overhead the policy "
                         "amortizes (host dispatch + weight upload)")
    ap.add_argument("--loop", action="store_true",
                    help="run the simulated request loop at each --rates "
                         "rate and print measured fill wait vs the "
                         "(b-1)/(2λ) closed form")
    ap.add_argument("--requests", type=int, default=2000, metavar="N",
                    help="requests per simulated loop / chaos session")
    ap.add_argument("--seed", type=int, default=0,
                    help="determinism seed for arrivals and chaos draws")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for --loop, and the "
                         "cold-search budget for --chaos lookups")
    ap.add_argument("--fill-ms", type=float, default=None,
                    help="batch-fill timer for --loop (partial batches "
                         "dispatch at this age)")
    ap.add_argument("--retries", type=int, default=3,
                    help="cold-search attempts in the retry envelope")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="run a fault-injection session, e.g. "
                         "'all=0.3' or 'worker_crash=0.5,stale_lock=0.2'")
    args = ap.parse_args(argv)

    arches = args.arch or ["edgenext-s"]
    batches = (tuple(int(b) for b in args.batches.split(","))
               if args.batches else BATCH_LEVELS)
    cache_dir = args.cache_dir or Path(
        tempfile.mkdtemp(prefix="repro-serve-"))
    deadline_s = (args.deadline_ms * 1e-3
                  if args.deadline_ms is not None else None)
    store = ServeStore(cache_dir, HWSpec(),
                       retry_attempts=args.retries,
                       search_deadline_s=deadline_s)
    print(f"# serve store at {cache_dir} "
          f"(arch={','.join(arches)} batches={list(batches)})")

    if args.warm:
        t0 = time.perf_counter()
        with obs.tracing() as tr:
            rep = store.warm(arches, batches=batches, jobs=args.jobs)
        dt = time.perf_counter() - t0
        print(f"serve.warm.entries,{len(rep.entries)},"
              f"{rep.searched} cold-searched, jobs={args.jobs}")
        print(f"serve.warm.wall_ms,{dt * 1e3:.6g},")
        _counter_rows("serve.warm", tr.counters)

    if args.lookup is not None:
        for arch in arches:
            with obs.tracing() as tr:
                t0 = time.perf_counter()
                sched = store.lookup(arch, args.lookup)
                dt = time.perf_counter() - t0
            name = store.resolve(arch, args.lookup)[0]
            print(f"serve.lookup.wall_ms,{dt * 1e3:.6g},{name}")
            print(f"serve.lookup.latency_ms,"
                  f"{sched.cost['latency_s'] * 1e3:.6g},"
                  f"groups={len(sched.groups)} "
                  f"lowered={len(sched.lowered)}")
            _counter_rows("serve", tr.counters)

    if args.rates:
        rates = parse_rates(args.rates)
        for arch in arches:
            pts = co_search(store, arch, batches=batches)
            for p in pts:
                print(f"serve.batch.{p.workload}.latency_ms,"
                      f"{p.latency_s * 1e3:.6g},"
                      f"{p.throughput_rps:.1f} rps back-to-back")
            picks = rate_table(pts, rates,
                               dispatch_s=args.dispatch_ms * 1e-3,
                               devices=args.devices)
            for pk in picks:
                sat = " SATURATED" if pk.saturated else ""
                print(f"serve.policy.{arch}.rate{pk.rate_rps:g}.batch,"
                      f"{pk.point.batch},"
                      f"exp_latency={pk.expected_latency_s * 1e3:.1f}ms "
                      f"sustained={pk.sustained_rps:.1f}rps "
                      f"shards={pk.devices}x b{pk.shard_point.batch}"
                      f"{sat}")
            print(f"serve.policy.{arch}.distinct_batches,"
                  f"{distinct_batches(picks)},over rates {rates}")

    if args.loop:
        from repro_torch.serve.loop import run_loop
        rates = parse_rates(args.rates)
        fill_s = args.fill_ms * 1e-3 if args.fill_ms is not None else None
        for arch in arches:
            for rate in rates:
                with obs.tracing() as tr:
                    rep = run_loop(
                        store, arch, rate_rps=rate,
                        n_requests=args.requests, seed=args.seed,
                        batches=batches,
                        dispatch_s=args.dispatch_ms * 1e-3,
                        devices=args.devices, fill_timeout_s=fill_s,
                        deadline_s=deadline_s)
                print(f"serve.loop.{arch}.rate{rate:g}.batch,{rep.batch},"
                      f"{rep.requests} req, {rep.batches} batches "
                      f"({rep.partial_batches} partial)")
                print(f"serve.loop.{arch}.rate{rate:g}.fill_wait_ms,"
                      f"{rep.fill_wait_mean_s * 1e3:.6g},"
                      f"model {rep.model_fill_wait_s * 1e3:.6g}ms")
                print(f"serve.loop.{arch}.rate{rate:g}.fillwait_err,"
                      f"{rep.fillwait_err:.4f},|measured-model|/model")
                if deadline_s is not None:
                    print(f"serve.loop.{arch}.rate{rate:g}.deadline_miss,"
                          f"{rep.deadline_misses},"
                          f"of {rep.requests} at {args.deadline_ms:g}ms")

    if args.chaos:
        from repro_torch.serve.chaos import ChaosPlan, chaos_session
        plan = ChaosPlan.parse(args.chaos, seed=args.seed)
        chaos_batches = tuple(b for b in batches if b <= 4) or batches[:1]
        for arch in arches:
            store.warm([arch], batches=chaos_batches)
            with obs.tracing() as tr:
                rep = chaos_session(store, arch,
                                    n_requests=args.requests, plan=plan,
                                    batches=chaos_batches)
            served = "all served" if rep.all_served else "REQUESTS LOST"
            print(f"serve.chaos.{arch}.served,{rep.served},"
                  f"of {rep.requests} — {served}")
            print(f"serve.chaos.{arch}.degraded,{rep.degraded},"
                  f"outcomes {dict(sorted(rep.outcomes.items()))}")
            _robustness_rows(tr.counters)
            if not rep.all_served:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
