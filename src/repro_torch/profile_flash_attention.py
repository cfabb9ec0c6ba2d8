"""Every launch shape of the whole-row flash attention at the XCA shapes.

    python -m repro_torch.profile_flash_attention [--out FILE.json]

Needs one CUDA device and ``nvcc``.  For each shape EdgeNeXt-S's XCA
gives ``csrc/flash_attention.cu`` (B*H = 64 and 4, Sq = Sk = the 24 / 40
/ 76 channels of a head, D = the 1024 / 256 / 64 tokens, non-causal,
scale 1, float32), it times the kernel at every cluster size and row
split that fits a block's shared memory, the online regime, and
``F.scaled_dot_product_attention`` on the same inputs, and marks the
split ``kernels.flash_attention.plan`` picks.  Times are CUDA-event
medians of 10 calls, one event pair around each call of the C entry
point (no wrapper on the host), the 50 MB L2 cache flushed (a 256 MB
buffer zeroed) before each.  Each line also gives the blocks a SM holds
(``plan``'s occupancy model) and the waves the grid takes on the card.
The first line times the smallest launch (one block, 16 x 16 x 8): the
fixed cost of a launch measured this way.

``--lm`` times only the entry point ``kernels.ops.flash_attention`` (no
other function of the package) at the LM stack's prefill shapes
(LM_CASES: bfloat16, causal; the online regime), beside
``F.scaled_dot_product_attention`` of the same function (``is_causal``, a
boolean mask where a window is set), the same way.  Run as a file with
another checkout's ``src`` first on PYTHONPATH, it times that checkout's
kernel, so that two versions are compared in one call on one card:

    PYTHONPATH=OTHER/src python src/repro_torch/profile_flash_attention.py --lm

Then the phases of one launch at the split ``plan`` picks: a copy of the
kernel with ``%globaltimer`` stamps (built under
``build/profile_flash_attention/``; the library the port loads is not
touched) gives, for block (0, 0), microseconds from its start to each of
PHASES, and over all blocks the span from the first start to the last
end, the last start and the longest block; medians of 7 calls, the L2
flushed before each.
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
import torch.nn.functional as F

from repro_torch.configs.edgenext_s import CONFIG
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa

SEED = 0
PHASES = ["q, k landed", "partial scores", "cluster barrier", "cluster sum",
          "softmax, v landed", "P V stored", "end"]


def _stamp(slot: int) -> str:
    return ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
            f"prof_t[{slot}] = prof_now();")


# (text in csrc/flash_attention.cu, the probe, the probe goes before it);
# each text must occur once
_PROBES = [
    ("namespace cg = cooperative_groups;\n", """
__device__ unsigned long long prof_t[16];  // block (0, 0); [8] first start, [9] last start,
                                           // [10] last end, [11] longest block
__device__ __forceinline__ unsigned long long prof_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""", False),
    ("  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;\n", """
  const unsigned long long prof_t0 = prof_now();
  if (threadIdx.x == 0) {
    atomicMin(&prof_t[8], prof_t0);
    atomicMax(&prof_t[9], prof_t0);
  }
  """ + _stamp(0) + "\n", False),
    ("  cp_async_wait<1>();  // q and k have landed\n  __syncthreads();\n",
     "  " + _stamp(1) + "\n", False),
    ("  cluster.sync();  // every block's partial scores are written\n",
     "  " + _stamp(2) + "\n", True),
    ("  cluster.sync();  // every block's partial scores are written\n",
     "  " + _stamp(3) + "\n", False),
    ('  asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");\n'
     "  __syncthreads();\n", "  " + _stamp(4) + "\n", False),
    ("  __syncthreads();     // and p and l are written\n",
     "  " + _stamp(5) + "\n", False),
    ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
     "  " + _stamp(6) + "\n", True),
    ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
     "  " + _stamp(7) + """
  if (threadIdx.x == 0) {
    const unsigned long long t1 = prof_now();
    atomicMax(&prof_t[10], t1);
    atomicMax(&prof_t[11], t1 - prof_t0);
  }
""", False),
]
_END = """
extern "C" int profile_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, prof_t, sizeof(prof_t));
}
extern "C" int profile_reset() {
  unsigned long long h[16] = {};
  h[8] = ~0ull;
  return (int)cudaMemcpyToSymbol(prof_t, h, sizeof(h));
}
"""


def instrumented_source() -> str:
    """csrc/flash_attention.cu with the stamps in; raises if the kernel no
    longer has the text a probe goes after."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, probe, before in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_flash_attention: {anchor!r} occurs "
                               f"{src.count(anchor)} times in flash_attention.cu")
        src = src.replace(anchor, probe + anchor if before else anchor + probe)
    return src + _END


def _library(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.headers():
        shutil.copy(header, out_dir / header.name)
    src = out_dir / "flash_attention_profiled.cu"
    src.write_text(instrumented_source())
    lib = out_dir / "libflash_attention_profiled.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(lib), str(src)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed\n" + run.stdout)
    return ctypes.CDLL(str(lib))


def phases(lib: ctypes.CDLL, BH: int, S: int, D: int, flush: torch.Tensor,
           sms: int, calls: int = 7) -> dict:
    """Block (0, 0)'s phases and the span over all blocks of one launch at
    the split ``plan`` picks (microseconds, medians of ``calls``)."""
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, D), dtype=np.float32))
               .cuda() for _ in range(3))
    out = torch.empty_like(q)
    p = fa.plan(BH, S, S, D, sms)
    fn = lib.repro_flash_attention
    fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
    lib.profile_read.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for _ in range(calls + 1):      # the first call is a warm-up
        flush.zero_()
        if lib.profile_reset() != 0:
            raise RuntimeError("profile_flash_attention: reset failed")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, BH, S,
                 S, D, 1.0, 0, 0, 0, 0, 1, p["splits"], p["row_splits"], 0, stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"profile_flash_attention: launch failed, CUDA "
                               f"error {err}")
        t = np.zeros(16, dtype=np.uint64)
        if lib.profile_read(t.ctypes.data) != 0:
            raise RuntimeError("profile_flash_attention: read failed")
        t = [int(x) for x in t]
        rows.append([(t[i] - t[0]) / 1e3 for i in range(1, 8)]
                    + [(t[10] - t[8]) / 1e3, (t[9] - t[8]) / 1e3, t[11] / 1e3])
    med = [statistics.median(r[i] for r in rows[1:]) for i in range(len(rows[0]))]
    return dict(bh=BH, s=S, d=D, splits=p["splits"], row_splits=p["row_splits"],
                ctas=p["ctas"], block00_us=dict(zip(PHASES, med[:7])),
                span_us=med[7], last_start_us=med[8], longest_block_us=med[9])


def xca_shapes(batch: int) -> list[tuple[int, int, int]]:
    """(BH, S, D) of the SDTA stages of an EdgeNeXt-S forward at ``batch``."""
    hw, out = CONFIG.img_size // 4, []
    for si in range(4):
        if si:
            hw //= 2
        if CONFIG.sdta_blocks[si]:
            out.append((batch * CONFIG.heads, CONFIG.dims[si] // CONFIG.heads,
                        hw * hw))
    return out


def time_ms(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep(BH: int, S: int, D: int, flush: torch.Tensor, sms: int,
          heads: int = CONFIG.heads) -> dict:
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, D), dtype=np.float32))
               .cuda() for _ in range(3))
    q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
    k = (k / k.norm(dim=-1, keepdim=True)).contiguous()
    out = torch.empty_like(q)
    fn = fa._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(regime, splits, rows):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                  BH, S, S, D, 1.0, 0, 0, 0, regime, splits, rows, 0, stream)

    # the library call on [B, H, S, D] views, as chip_smoke.py times it
    q4, k4, v4 = (t.view(BH // heads, heads, S, D) for t in (q, k, v))
    want = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0).reshape(BH, S, D)
    chosen = fa.plan(BH, S, S, D, sms)
    tiles, units = -(-S // fa.ROW_TILE), -(-D // fa.unit(4))
    runs = []
    for splits in (c for c in fa.CLUSTER if c <= units):
        for rows in range(1, tiles + 1):
            smem = fa.smem_bytes(fa.ROW_TILE * -(-tiles // rows), S,
                                 fa.unit(4) * -(-units // splits))
            if smem > fa.SMEM_BYTES:
                continue
            if launch(1, splits, rows) != 0:
                raise RuntimeError(f"launch failed at splits {splits} rows {rows}")
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            ctas = BH * splits * rows
            per_sm = fa.blocks_per_sm(smem)
            runs.append(dict(
                splits=splits, row_splits=rows, ctas=ctas, smem=smem,
                blocks_per_sm=per_sm, waves=-(-ctas // (per_sm * sms)),
                ms=time_ms(lambda: launch(1, splits, rows), flush),
                max_abs_err=err,
                planned=(chosen["regime"], chosen["splits"],
                         chosen["row_splits"]) == ("rows", splits, rows)))
    online = time_ms(lambda: launch(0, 0, 0), flush)
    library = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0),
                      flush)
    return dict(bh=BH, s=S, d=D, runs=runs, online_ms=online, library_ms=library)


# (name, B, H, S, D, window): the dense path's prefill attention,
# h2o-danube-1.8b at 4 x 512 and at 1 x 4608 over its window of 4096, and
# olmo-1b at 4 x 512
LM_CASES = [("h2o 4x32x512 D80", 4, 32, 512, 80, None),
            ("h2o 1x32x4608 D80 window 4096", 1, 32, 4608, 80, 4096),
            ("olmo 4x16x512 D128", 4, 16, 512, 128, None)]


def lm_times(flush: torch.Tensor) -> list[dict]:
    """``ops.flash_attention`` and SDPA at LM_CASES, each checked against
    ``ref.attention_ref`` at 2e-2."""
    rng = np.random.default_rng(SEED)
    rows = []
    for name, B, H, S, D, window in LM_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.attention_ref(q, k, v, causal=True, window=window)
        err = (got.float() - want.float()).abs().max().item()
        del want
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
        else:
            i = torch.arange(S, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
        row = dict(case=name, max_abs_err=err,
                   ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                          window=window), flush),
                   library_ms=time_ms(lib, flush))
        rows.append(row)
        print(f"lm {name}: ms {row['ms']:.4f} library {row['library_ms']:.4f} "
              f"max err {err:.2e}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--lm", action="store_true",
                    help="time only ops.flash_attention at the LM prefill shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash_attention: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device {smi}", flush=True)
    _build.library()
    if args.lm:
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
        package = str(Path(_build.__file__).parents[2])
        print(f"lm: the package at {package}", flush=True)
        rows = lm_times(flush)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(device=smi, package=package, lm=rows), f, indent=1)
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    floor = sweep(1, 16, 8, flush, sms, heads=1)["runs"][0]["ms"]
    print(f"floor: one block (1 x 16 x 16 x 8) {floor:.4f} ms", flush=True)
    results = []
    for batch in (16, 1):
        for BH, S, D in xca_shapes(batch):
            r = sweep(BH, S, D, flush, sms)
            results.append(r)
            print(f"xca {BH}x{S}x{S}x{D}: library {r['library_ms']:.4f} ms, "
                  f"online {r['online_ms']:.4f} ms", flush=True)
            for run in sorted(r["runs"], key=lambda x: x["ms"]):
                print(f"  splits {run['splits']} rows {run['row_splits']}: "
                      f"{run['ms']:.4f} ms, ctas {run['ctas']}, "
                      f"{run['blocks_per_sm']} a SM, {run['waves']} wave(s), "
                      f"err {run['max_abs_err']:.1e}"
                      f"{'  <- plan' if run['planned'] else ''}", flush=True)
    lib = _library(_build._build_root() / "profile_flash_attention")
    timelines = []
    for batch in (16, 1):
        for BH, S, D in xca_shapes(batch):
            r = phases(lib, BH, S, D, flush, sms)
            timelines.append(r)
            steps = ", ".join(f"{k} {x:.2f}" for k, x in r["block00_us"].items())
            print(f"phases {BH}x{S}x{S}x{D} splits {r['splits']} rows "
                  f"{r['row_splits']} ctas {r['ctas']}: block (0,0) us: {steps}; "
                  f"all blocks: span {r['span_us']:.2f}, last start "
                  f"{r['last_start_us']:.2f}, longest block "
                  f"{r['longest_block_us']:.2f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, floor_ms=floor, shapes=results,
                           phases=timelines), f, indent=1)


if __name__ == "__main__":
    main()
