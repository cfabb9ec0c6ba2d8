"""Where a ``matmul_ln`` launch spends its time on the card, phase by phase.

    PYTHONPATH=src python -m repro_torch.profile_matmul_ln [--out phases.json]

Builds a copy of ``kernels/csrc/matmul_ln.cu`` with ``%globaltimer`` stamps
(under ``build/profile_matmul_ln/``; the library the port loads is not
touched) and launches it at the float32 shapes ``chip_smoke.py`` times, with
the blocks ``search.lower`` gives them and the cluster size of
``kernels.matmul_ln.plan``, the L2 flushed before each call.  For block
(0, 0): microseconds from its start to its first slab, to the end of its
slab loop, past each of the three cluster barriers of the statistics, and
to its end.  Over all blocks: the span from the first start to the last
end, the last start and the longest block.  Also what the runtime reports
for the launch: blocks a SM and clusters active at once.  Medians of 7
calls.  Needs one CUDA device and ``nvcc``; there is no CPU fallback.
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

from repro_torch.core.workload import NORM, PWCONV, Layer
from repro_torch.kernels import _build
from repro_torch.kernels import matmul_ln as mln
from repro_torch.search import lower

SHAPES = [(16384, 96, 96), (4096, 160, 160), (1024, 304, 304),
          (512, 2048, 2048), (448, 2560, 2560)]
PHASES = ["first slab", "slab loop", "barrier 1", "barrier 2", "barrier 3",
          "end"]
SEED = 0


def _stamp(slot: int) -> str:
    return ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
            f"prof_t[{slot}] = prof_now();")


# (text in csrc/matmul_ln.cu, what goes after it); each must occur once,
# the barriers in order
_PROBES = [
    ("namespace cg = cooperative_groups;\n", """
__device__ unsigned long long prof_t[16];  // block (0, 0); [8] first start, [9] last start,
                                           // [10] last end, [11] longest block
__device__ __forceinline__ unsigned long long prof_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;\n", """
  const unsigned long long prof_t0 = prof_now();
  if (tid == 0) {
    atomicMin(&prof_t[8], prof_t0);
    atomicMax(&prof_t[9], prof_t0);
  }
  """ + _stamp(0) + "\n"),
    ("      __syncthreads();              // for every thread; and slab i - 1 is read\n",
     "      if (i == 0) {" + _stamp(1) + "}\n"),
    ("    __syncthreads();  // the row buffer is whole\n", "    " + _stamp(2) + "\n"),
    ("    cluster.sync();\n    if (tid < BM) mean_s", None),
    ("    cluster.sync();\n    if (tid < BM) rstd_s", None),
    ("    // row tile) or leaves while another still reads it; rstd_s is visible\n"
     "    cluster.sync();\n", "    " + _stamp(5) + "\n"),
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
// blocks a SM and clusters active at once for the float32 instance and
// shared memory launch() picks
template <int BM>
int occupancy_(long long M, int N, int S, int* out) {
  const int groups = (N + 7) / 8, ns_max = 8 * ((groups + S - 1) / S);
  const int ldy = ns_max + (40 - ns_max % 32) % 32;
  const bool three = Layout<float, BM>::bytes(3, ldy) <= (size_t)SMEM_OPT_IN;
  auto kern = three ? matmul_ln_kernel<float, BM, 3> : matmul_ln_kernel<float, BM, 2>;
  const size_t smem = Layout<float, BM>::bytes(three ? 3 : 2, ldy);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_OPT_IN);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, NT, smem);
  cudaLaunchConfig_t cfg = {};
  const long long row_tiles = (M + BM - 1) / BM;
  cfg.gridDim = dim3((unsigned)S, (unsigned)(row_tiles < 65535 ? row_tiles : 65535), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&out[1], kern, &cfg);
  return (int)err;
}
extern "C" int profile_occupancy(int bm, long long M, int N, int S, int* out) {
  switch (bm) {
    case 8: return occupancy_<8>(M, N, S, out);
    case 16: return occupancy_<16>(M, N, S, out);
    case 32: return occupancy_<32>(M, N, S, out);
    case 64: return occupancy_<64>(M, N, S, out);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def instrumented_source() -> str:
    """csrc/matmul_ln.cu with the stamps in; raises if the kernel no longer
    has the text a probe goes after."""
    src = (_build.CSRC / "matmul_ln.cu").read_text()
    slot = 3
    for anchor, probe in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_matmul_ln: {anchor!r} occurs "
                               f"{src.count(anchor)} times in matmul_ln.cu")
        if probe is None:   # the first two barriers: stamp right after them
            head = "    cluster.sync();\n"
            probe = "    " + _stamp(slot) + "\n"
            slot += 1
            src = src.replace(anchor, head + probe + anchor[len(head):])
        else:
            src = src.replace(anchor, anchor + probe)
    # the block's end: after the row-tile loop, before the kernel returns
    tail = "  }\n}\n\nconstexpr int MAX_DEVICES"
    if src.count(tail) != 1:
        raise RuntimeError("profile_matmul_ln: the kernel's end moved")
    src = src.replace(tail, "  }\n  " + _stamp(6) + """
  if (threadIdx.x == 0) {
    const unsigned long long t1 = prof_now();
    atomicMax(&prof_t[10], t1);
    atomicMax(&prof_t[11], t1 - prof_t0);
  }
}

constexpr int MAX_DEVICES""")
    return src + _END


def _library(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.headers():
        shutil.copy(header, out_dir / header.name)
    src = out_dir / "matmul_ln_profiled.cu"
    src.write_text(instrumented_source())
    lib = out_dir / "libmatmul_ln_profiled.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(lib), str(src)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed\n" + run.stdout)
    return ctypes.CDLL(str(lib))


def profile(lib: ctypes.CDLL, M: int, K: int, N: int, calls: int = 7) -> dict:
    blocks = lower.lower_matmul_ln(Layer("mac", PWCONV, k=N, c=K, ox=M),
                                   Layer("ln", NORM, c=N, ox=M),
                                   tile_x=64, tile_c=128).params
    bm = blocks["block_m"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = mln.plan(M, N, sms, block_m=bm)["splits"]
    rng = np.random.default_rng(SEED)
    x, w, b, g, be = (torch.from_numpy((rng.standard_normal(s) * sc)
                                       .astype(np.float32)).cuda()
                      for s, sc in (((M, K), 1.0), ((K, N), K ** -0.5),
                                    ((N,), 0.1), ((N,), 0.1), ((N,), 0.1)))
    g += 1.0
    out = torch.empty((M, N), device="cuda")
    fn = lib.repro_matmul_ln
    fn.argtypes, fn.restype = mln._ARGTYPES, ctypes.c_int
    lib.profile_read.argtypes = [ctypes.c_void_p]
    lib.profile_occupancy.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    occ = np.zeros(2, dtype=np.int32)
    if lib.profile_occupancy(bm, M, N, splits, occ.ctypes.data) != 0:
        raise RuntimeError("profile_matmul_ln: occupancy query failed")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for _ in range(calls + 1):      # the first call is a warm-up
        flush.zero_()
        if lib.profile_reset() != 0:
            raise RuntimeError("profile_matmul_ln: reset failed")
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                 be.data_ptr(), out.data_ptr(), M, K, N, bm, splits, 1e-6, 0,
                 stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"profile_matmul_ln: launch failed, CUDA error {err}")
        t = np.zeros(16, dtype=np.uint64)
        if lib.profile_read(t.ctypes.data) != 0:
            raise RuntimeError("profile_matmul_ln: read failed")
        t = [int(v) for v in t]
        rows.append([(t[i] - t[0]) / 1e3 for i in range(1, 7)]
                    + [(t[10] - t[8]) / 1e3, (t[9] - t[8]) / 1e3, t[11] / 1e3])
    med = [statistics.median(r[i] for r in rows[1:]) for i in range(len(rows[0]))]
    return dict(shape=[M, K, N], block_m=bm, splits=splits,
                ctas=splits * -(-M // bm), blocks_per_sm=int(occ[0]),
                active_clusters=int(occ[1]),
                block00_us=dict(zip(PHASES, med[:6])),
                span_us=med[6], last_start_us=med[7], longest_block_us=med[8])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_matmul_ln: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device {smi}")
    lib = _library(_build._build_root() / "profile_matmul_ln")
    results = []
    for M, K, N in SHAPES:
        r = profile(lib, M, K, N)
        results.append(r)
        phases = ", ".join(f"{k} {v:.2f}" for k, v in r["block00_us"].items())
        print(f"matmul_ln {M}x{K}->{N} block_m={r['block_m']} splits {r['splits']} "
              f"ctas {r['ctas']} (blocks/SM {r['blocks_per_sm']}, clusters at once "
              f"{r['active_clusters']}): block (0,0) us: {phases}; all blocks: span "
              f"{r['span_us']:.2f}, last start {r['last_start_us']:.2f}, longest "
              f"block {r['longest_block_us']:.2f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=smi, shapes=results),
                                             indent=1))


if __name__ == "__main__":
    main()
