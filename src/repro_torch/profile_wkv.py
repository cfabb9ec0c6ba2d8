"""Every configuration of the chunked WKV kernel's outputs pass, each pass
alone, the chunk sweep, and the phases of one launch.

    python -m repro_torch.profile_wkv [--out FILE.json]
    PYTHONPATH=OTHER/src python src/repro_torch/profile_wkv.py --ops [--out FILE.json]

Needs one CUDA device and ``nvcc``.  Two copies of ``csrc/wkv_chunked.cu``
are built under ``build/profile_wkv/`` (the library the port loads is not
touched), both with a switch that launches the states pass alone, the
outputs pass alone or both: ``passes/`` as it is otherwise, ``stamps/``
with ``%globaltimer`` stamps.

At RWKV-6's served prefill shape (B*H = 4*32, T = 512, K = V = 64, chunk
64, bfloat16 r/k/v, float32 logw and u), at the B = 1 x 200 prompt
(32 x 200 x 64 x 64) and at RecurrentGemma's lowered K = 1, V = 2560,
T = 448 (float32), it times, through the C entry of ``passes/``: the
outputs pass alone at every configuration
``kernels.rwkv_chunk.candidates`` lists (warps a tile, rows and warps a
block), the states pass alone, and the two passes together at
the configuration ``kernels.rwkv_chunk.plan`` picks (``<- plan`` marks
it, with its rank).  Each configuration is checked against
``ref.wkv_ref``.  Times are CUDA-event medians of 10 calls, one event pair
around each call of the C entry (no wrapper on the host), the 50 MB L2
cache flushed (a 256 MB buffer zeroed) before each.

The chunk sweep times both passes at the plan for each of CHUNKS at the
served shape and at RecurrentGemma's, in ROUNDS rounds that alternate the
order of the chunks, and gives each chunk's median, least and most over
the rounds: the spread that ``kernels.rwkv_chunk.CHUNK`` is chosen
against.

Then the phases of one launch at the plan, from ``stamps/``: for block
(0, 0, 0) of the states pass, the microseconds its slab loop spent in
each of STATES_PHASES summed over the slabs, and for the outputs pass's block (0, tiles - 1, 0)
(chunk 0's last row tile, whose warps have the most earlier tiles)
microseconds from its start to the copies landed and the cumsum, then
warp 0's time in each of OUTPUTS_PHASES summed over its tiles; and
for each pass over all warps the span from the first start to the last
end, the last start and the longest warp, and how long after the states
pass's end the first outputs block started (negative: the passes
overlap, the outputs pass being a programmatic dependent launch); medians
of 7 calls.

``--ops`` times only the entry point ``kernels.ops.wkv_chunked`` (no
other function of the package) at ``chip_smoke.py``'s WKV shapes
(OPS_SHAPES), the same way: run as a file with another checkout's ``src``
first on PYTHONPATH, it times that checkout's kernel, so that two versions
are compared in one call on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv_chunk as wkv
from repro_torch.profile_flash_attention import time_ms

SEED = 0
# (name, BH, T, K, V, chunk, r/k/v dtype)
SHAPES = [("served", 128, 512, 64, 64, 64, torch.bfloat16),
          ("prompt_200", 32, 200, 64, 64, 64, torch.bfloat16),
          ("recurrentgemma", 1, 448, 1, 2560, 64, torch.float32)]
# chip_smoke.py's timed WKV shapes: (BH, T, K, V, chunk, r/k/v dtype)
OPS_SHAPES = [(128, 512, 64, 64, 64, torch.bfloat16), (128, 512, 64, 64, 64, torch.float32),
              (32, 200, 64, 64, 64, torch.bfloat16)] \
    + [(128, 512, 64, 64, c, torch.float32) for c in (8, 16, 32, 128, 256)] \
    + [(1, 448, 1, 2560, 64, torch.float32), (1, 448, 1, 2560, 256, torch.float32)]
# the chunk sweep: (name, BH, T, K, V, r/k/v dtype), the chunks, the rounds
CHUNK_SHAPES = [("served", 128, 512, 64, 64, torch.bfloat16),
                ("recurrentgemma", 1, 448, 1, 2560, torch.float32)]
CHUNKS = (16, 32, 64, 128)
ROUNDS = 6
STATES_PHASES = ["copies landed", "cumsum", "products"]
OUTPUTS_PHASES = ["diagonal", "q", "earlier tiles", "inter (after the wait)", "store"]

# the switch of both copies: the passes a call of the C entry launches
_SWITCH = """
static int prof_passes = 3;   // 1: the states pass alone, 2: the outputs pass alone, 3: both
extern "C" void profile_passes(int passes) { prof_passes = passes; }
"""
_SWAPS = [("  const cudaError_t err = launch_states<Tin>(a, s);\n"
           "  if (err != cudaSuccess) return err;\n",
           "  const cudaError_t err = prof_passes & 1 ? launch_states<Tin>(a, s) : cudaSuccess;\n"
           "  if (err != cudaSuccess || !(prof_passes & 2)) return err;\n")]
_PROLOGUE = """
__device__ unsigned long long prof_s[16];  // states pass: [0..2] block (0,0,0)'s phases,
                                           // [8] first start, [9] last start,
                                           // [10] last end, [11] longest block
__device__ unsigned long long prof_o[16];  // outputs pass: [0] landed, [1] cumsum,
                                           // [2..6] warp 0's phases, [8..11] as above
__device__ __forceinline__ unsigned long long prof_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void prof_span(unsigned long long* p, unsigned long long t0) {
  const unsigned long long t1 = prof_now();
  atomicMin(&p[8], t0);
  atomicMax(&p[9], t0);
  atomicMax(&p[10], t1);
  atomicMax(&p[11], t1 - t0);
}
"""
_S_ME = "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0"
_O_ME = "blockIdx.x == 0 && blockIdx.y == tpc - 1 && blockIdx.z == 0 && threadIdx.x == 0"


def _acc(slot: int, arr: str, me: str) -> str:
    return (f"{{ const unsigned long long pn = prof_now(); if ({me}) {arr}[{slot}] += pn - "
            f"prof_ta; prof_ta = pn; }}\n")


# (text in csrc/wkv_chunked.cu, the probe, the probe goes before it); each
# text must occur once
_PROBES = [
    ('#include "mma.cuh"\n', _PROLOGUE, False),
    # the states pass
    ("  const int vp = L.vpitch / isz;\n",
     "  const unsigned long long prof_t0 = prof_now();\n"
     "  unsigned long long prof_ta = prof_t0;\n", False),
    ("  for (int si = 0; si < n_slabs; ++si) {\n", "    prof_ta = prof_now();\n", False),
    ("    cp_async_wait<STAGES - 1>();   // slab si has landed\n    __syncwarp();\n",
     "    " + _acc(0, "prof_s", _S_ME), False),
    ("    // the segments [a, e) of the slab", "    " + _acc(1, "prof_s", _S_ME), True),
    ("    __syncwarp();   // before the next slab's copies reuse this stage\n",
     "    " + _acc(2, "prof_s", _S_ME), True),
    ("  store_state(state + bh * K * (long long)V, S, K, V, k0, v0, g, tq);\n}\n",
     "  if (lane == 0) prof_span(prof_s, prof_t0);\n", True),
    # the outputs pass
    ("  const long long row0 = bh * T + c0;\n",
     "  const unsigned long long prof_t0 = prof_now();\n"
     "  unsigned long long prof_ta = prof_t0;\n", False),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", "  " + _acc(0, "prof_o", _O_ME), False),
    ("  // 3. the tiles, in a zigzag over the groups of wv warps; warp h of\n",
     "  " + _acc(1, "prof_o", _O_ME), True),
    ("    a_times_v(acc, pb, ldp, vt + j0 * ldvt + vc, ldvt, lane);\n",
     "    " + _acc(2, "prof_o", _O_ME), False),
    ("    // 3c. each earlier tile", "    " + _acc(3, "prof_o", _O_ME), True),
    ("    // 3d. inter = (q * 2^rho) @ S", "    " + _acc(4, "prof_o", _O_ME), True),
    ("    // 3e. out, once, in r's type", "    " + _acc(5, "prof_o", _O_ME), True),
    ("    group_sync();   // pb and qb are rewritten for the next tile\n",
     "    " + _acc(6, "prof_o", _O_ME), True),
    ("    group_sync();   // pb and qb are rewritten for the next tile\n  }\n",
     "  if (lane == 0) prof_span(prof_o, prof_t0);\n", False),
]
_END = """
extern "C" int profile_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, prof_s, sizeof(prof_s));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(host + 16, prof_o, sizeof(prof_o));
}
extern "C" int profile_reset() {
  unsigned long long h[16] = {};
  h[8] = ~0ull;
  cudaError_t e = cudaMemcpyToSymbol(prof_s, h, sizeof(h));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(prof_o, h, sizeof(h));
}
"""


def _once(src: str, anchor: str) -> None:
    if src.count(anchor) != 1:
        raise RuntimeError(f"profile_wkv: {anchor!r} occurs {src.count(anchor)} "
                           f"times in wkv_chunked.cu")


def instrumented_source(stamps: bool = True) -> str:
    """csrc/wkv_chunked.cu with the pass switch and, with ``stamps``, the
    stamps in; raises if the kernel no longer has the text a probe goes
    after or a swap replaces."""
    src = (_build.CSRC / "wkv_chunked.cu").read_text()
    for old, new in _SWAPS:
        _once(src, old)
        src = src.replace(old, new)
    include = '#include "mma.cuh"\n'
    _once(src, include)
    src = src.replace(include, include + _SWITCH)
    for anchor, probe, before in _PROBES if stamps else []:
        _once(src, anchor)
        src = src.replace(anchor, probe + anchor if before else anchor + probe)
    return src + (_END if stamps else "")


def _libraries(root: Path) -> dict:
    """``passes`` and ``stamps``: the two copies, built at once."""
    runs = {}
    for name in ("passes", "stamps"):
        out_dir = root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in _build.headers():
            shutil.copy(header, out_dir / header.name)
        src = out_dir / "wkv_chunked_profiled.cu"
        src.write_text(instrumented_source(stamps=name == "stamps"))
        lib = out_dir / "libwkv_chunked_profiled.so"
        runs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, run) in runs.items():
        log = run.communicate()[0]
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy\n" + log)
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].repro_wkv_chunked
        fn.argtypes, fn.restype = wkv._ARGTYPES, ctypes.c_int
        libs[name].profile_passes.argtypes = [ctypes.c_int]
    return libs


def inputs(BH, T, K, V, dtype):
    """r, k, v, u ~ N(0, 0.5^2) in ``dtype`` (u float32), logw =
    -exp(N(0, 0.5^2)) float32, as the JAX WKV tests draw them."""
    rng = np.random.default_rng(SEED)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32) * 0.5).cuda()
    r, k, v = n(BH, T, K).to(dtype), n(BH, T, K).to(dtype), n(BH, T, V).to(dtype)
    logw = -torch.exp(n(BH, T, K))
    return r, k, v, logw, n(BH, K)


class Call:
    """One shape's tensors and a copy's C entry at any configuration."""

    def __init__(self, lib, BH, T, K, V, C, dtype):
        self.lib, self.dims, self.C = lib, (BH, T, K, V), C
        self.args = inputs(BH, T, K, V, dtype)
        r = self.args[0]
        self.out = torch.empty((BH, T, V), dtype=dtype, device=r.device)
        self.state = torch.empty((BH, K, V), device=r.device)
        self.ws = wkv.workspace(BH, T, K, V, C, r.device)
        self.codes = [0 if t.dtype == torch.float32 else 1
                      for t in (r, self.args[3], self.args[4])]
        self.stream = torch.cuda.current_stream().cuda_stream
        self.want = ref.wkv_ref(*self.args)

    def launcher(self, p: dict, passes: int = 3):
        """A call of the C entry at plan ``p`` that launches ``passes`` (1
        the states pass, 2 the outputs pass, 3 both)."""
        ptrs = [t.data_ptr() for t in self.args] + [
            None, self.out.data_ptr(), self.state.data_ptr(), self.ws.data_ptr()]
        conf = [p[key] for key in ("wv", "warps", "rows")]

        def launch():
            self.lib.profile_passes(passes)
            return self.lib.repro_wkv_chunked(*ptrs, *self.dims, self.C, *self.codes, *conf,
                                              self.stream)
        return launch

    def check(self, p: dict) -> float:
        """Both passes at ``p``; the larger of the max errors of out and of
        the state against ``wkv_ref``, each within its tolerance."""
        self.out.zero_()
        if self.launcher(p)() != 0:
            raise RuntimeError(f"profile_wkv: launch failed at {p}")
        torch.cuda.synchronize()
        tol = 2e-4 if self.out.dtype == torch.float32 else 2e-2
        errs = []
        for got, want, t in ((self.out, self.want[0], tol), (self.state, self.want[1], 2e-4)):
            err = (got.float() - want.float()).abs()
            if not bool((err <= t + t * want.float().abs()).all()):
                raise RuntimeError(f"profile_wkv: {self.dims} at {p}: max err "
                                   f"{err.max().item():.3e}")
            errs.append(err.max().item())
        return max(errs)


def _plan(call: Call, sms: int) -> dict:
    r, logw = call.args[0], call.args[3]
    return wkv.plan(*call.dims, call.C, r.element_size(),
                    logw_itemsize=logw.element_size(), sms=sms)


def sweep(lib, name, BH, T, K, V, C, dtype, flush, sms) -> dict:
    call = Call(lib, BH, T, K, V, C, dtype)
    chosen = _plan(call, sms)
    err = call.check(chosen)
    total = time_ms(call.launcher(chosen), flush)
    states = time_ms(call.launcher(chosen, 1), flush)
    outputs = []
    for cand in wkv.candidates(BH, T, K, V, C, *(call.args[i].element_size() for i in (0, 3))):
        p = dict(chosen, **cand)
        call.check(p)
        outputs.append(dict(cand, ms=time_ms(call.launcher(p, 2), flush),
                            planned=all(cand[k] == chosen[k]
                                        for k in ("wv", "rows", "warps"))))
    return dict(name=name, bh=BH, t=T, k=K, v=V, chunk=C, dtype=str(dtype).split(".")[-1],
                plan=chosen, plan_ms=total, states_ms=states, max_abs_err=err,
                outputs=outputs)


def chunk_sweep(lib, flush, sms) -> list[dict]:
    """Both passes at the plan for each of CHUNKS at CHUNK_SHAPES, ROUNDS
    rounds, the chunks forward in even rounds and backward in odd ones:
    each chunk's median, least and most ms over the rounds."""
    rows = []
    for name, BH, T, K, V, dt in CHUNK_SHAPES:
        calls = {c: Call(lib, BH, T, K, V, c, dt) for c in CHUNKS}
        launch = {}
        for c, call in calls.items():
            p = _plan(call, sms)
            call.check(p)
            launch[c] = call.launcher(p)
        times = {c: [] for c in CHUNKS}
        for i in range(ROUNDS):
            for c in CHUNKS if i % 2 == 0 else CHUNKS[::-1]:
                times[c].append(time_ms(launch[c], flush))
        for c in CHUNKS:
            rows.append(dict(name=name, bh=BH, t=T, k=K, v=V, chunk=c,
                             dtype=str(dt).split(".")[-1], rounds=times[c],
                             median_ms=statistics.median(times[c]),
                             min_ms=min(times[c]), max_ms=max(times[c])))
    return rows


def phases(lib, BH, T, K, V, C, dtype, flush, sms, calls: int = 7) -> dict:
    """The stamps of one launch of both passes at the plan (microseconds,
    medians of ``calls``)."""
    lib.profile_read.argtypes = [ctypes.c_void_p]
    call = Call(lib, BH, T, K, V, C, dtype)
    p = _plan(call, sms)
    launch = call.launcher(p)
    rows = []
    for _ in range(calls + 1):      # the first call is a warm-up
        flush.zero_()
        if lib.profile_reset() != 0:
            raise RuntimeError("profile_wkv: reset failed")
        err = launch()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"profile_wkv: launch failed, CUDA error {err}")
        t = np.zeros(32, dtype=np.uint64)
        if lib.profile_read(t.ctypes.data) != 0:
            raise RuntimeError("profile_wkv: read failed")
        t = [int(x) / 1e3 for x in t]
        s, o = t[:16], t[16:]
        rows.append(s[:3] + [s[10] - s[8], s[9] - s[8], s[11]]
                    + o[:7] + [o[10] - o[8], o[9] - o[8], o[11], o[8] - s[10]])
    med = [statistics.median(r[i] for r in rows[1:]) for i in range(len(rows[0]))]
    return dict(bh=BH, t=T, k=K, v=V, chunk=C, plan=p,
                states_block0_us=dict(zip(STATES_PHASES, med[:3])),
                states_span_us=med[3], states_last_start_us=med[4],
                states_longest_block_us=med[5],
                outputs_block_us={"copies landed": med[6], "cumsum": med[7]},
                outputs_warp0_us=dict(zip(OUTPUTS_PHASES, med[8:13])),
                outputs_span_us=med[13], outputs_last_start_us=med[14],
                outputs_longest_block_us=med[15], start_after_states_end_us=med[16])


def _conf(r: dict) -> str:
    return (f"V tile {wkv.BVS * r['wv']} ({r['wv']} warps a tile) rows {r['rows']} "
            f"warps {r['warps']}")


def ops_times(flush) -> list[dict]:
    """``ops.wkv_chunked`` at OPS_SHAPES: ms and max errors against
    ``wkv_ref`` (out, state)."""
    from repro_torch.kernels import ops
    rows = []
    for BH, T, K, V, C, dt in OPS_SHAPES:
        args = inputs(BH, T, K, V, dt)
        out, state = ops.wkv_chunked(*args, chunk=C)
        want = ref.wkv_ref(*args)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((out, state), want)]
        ms = time_ms(lambda: ops.wkv_chunked(*args, chunk=C), flush)
        rows.append(dict(bh=BH, t=T, k=K, v=V, chunk=C, dtype=str(dt).split(".")[-1], ms=ms,
                         max_abs_err_out=errs[0], max_abs_err_state=errs[1]))
        print(f"ops wkv_chunked[{BH}x{T}x{K}->{V} chunk={C} {rows[-1]['dtype']}]: "
              f"{ms:.4f} ms, err out {errs[0]:.2e} state {errs[1]:.2e}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--top", type=int, default=5, help="fastest configurations printed")
    ap.add_argument("--ops", action="store_true",
                    help="time only ops.wkv_chunked at chip_smoke.py's WKV shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device {smi}", flush=True)
    _build.library()
    if args.ops:
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
        print(f"ops: the package at {Path(_build.__file__).parents[2]}", flush=True)
        rows = ops_times(flush)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(device=smi, package=str(Path(_build.__file__).parents[2]),
                               ops=rows), f, indent=1)
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    libs = _libraries(_build._build_root() / "profile_wkv")
    results = []
    for name, BH, T, K, V, C, dt in SHAPES:
        r = sweep(libs["passes"], name, BH, T, K, V, C, dt, flush, sms)
        results.append(r)
        print(f"wkv {name} {BH}x{T}x{K}->{V} chunk {C} {r['dtype']}: plan {r['plan_ms']:.4f} ms "
              f"(max err {r['max_abs_err']:.2e}); states pass alone {r['states_ms']:.4f} ms",
              flush=True)
        runs = sorted(r["outputs"], key=lambda x: x["ms"])
        rank = next(i for i, x in enumerate(runs) if x["planned"])
        print(f"  outputs pass alone: {len(runs)} configurations, plan's rank {rank + 1} at "
              f"{runs[rank]['ms']:.4f} ms ({runs[rank]['ms'] / runs[0]['ms']:.2f}x the "
              f"fastest)", flush=True)
        for i, run in enumerate(runs):
            if i < args.top or run["planned"]:
                print(f"    {_conf(run)}: {run['ms']:.4f} ms, ctas {run['ctas']}, smem "
                      f"{run['smem']}{'  <- plan' if run['planned'] else ''}", flush=True)
    chunks = chunk_sweep(libs["passes"], flush, sms)
    for row in chunks:
        print(f"chunk {row['name']} {row['bh']}x{row['t']}x{row['k']}->{row['v']} "
              f"{row['dtype']} chunk {row['chunk']}: median {row['median_ms']:.4f} ms over "
              f"{ROUNDS} rounds (least {row['min_ms']:.4f}, most {row['max_ms']:.4f})",
              flush=True)
    timelines = []
    for name, BH, T, K, V, C, dt in SHAPES:
        r = phases(libs["stamps"], BH, T, K, V, C, dt, flush, sms)
        r["name"] = name
        timelines.append(r)
        st = ", ".join(f"{k} {v:.2f}" for k, v in r["states_block0_us"].items())
        ob = ", ".join(f"{k} {v:.2f}" for k, v in r["outputs_block_us"].items())
        ow = ", ".join(f"{k} {v:.2f}" for k, v in r["outputs_warp0_us"].items())
        print(f"phases {name}: states block (0,0,0) us summed over slabs: {st}; all blocks: "
              f"span {r['states_span_us']:.2f}, last start {r['states_last_start_us']:.2f}, "
              f"longest {r['states_longest_block_us']:.2f}", flush=True)
        print(f"phases {name}: outputs block (0,tiles-1,0) us from its start: {ob}; warp 0 "
              f"summed over its tiles: {ow}; all blocks: span {r['outputs_span_us']:.2f}, "
              f"last start {r['outputs_last_start_us']:.2f}, longest "
              f"{r['outputs_longest_block_us']:.2f}; first start after the states pass's end "
              f"{r['start_after_states_end_us']:.2f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, shapes=results, chunks=chunks, phases=timelines), f,
                      indent=1)


if __name__ == "__main__":
    main()
