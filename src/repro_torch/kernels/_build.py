"""Builds the CUDA sources under ``csrc/`` and loads them with ``ctypes``.

The sources have a plain C interface and include none of PyTorch's
headers, so ``nvcc`` compiles each in a few seconds.  Every ``*.cu`` is
compiled to an object file by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o librepro_kernels.so *.o

The library goes to ``build/repro_torch_kernels/<hash of the sources>/``
(the ``*.cu`` and the ``*.cuh`` headers they include)
under the root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides the
``build`` directory), is built at first use and reused while the sources
keep their hash.  What ``-Xptxas -v`` says about registers, shared memory
and spills is kept beside it in ``ptxas.log``.

Nothing here runs when the module is imported.  A build that fails raises
``RuntimeError`` with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None: not built by this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch are built from source at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> root of the checkout
    return Path(__file__).resolve().parents[3] / "build"


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _build_root() / "repro_torch_kernels" / h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed, objs = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc -shared failed\n" + link.stdout)
    (out_dir / "ptxas.log").write_text("\n".join(log))
    os.replace(tmp / LIB_NAME, out_dir / LIB_NAME)   # atomic: readers see all or nothing
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The shared library of all kernels, built first if it is not there."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            out_dir = build_dir()
            if not (out_dir / LIB_NAME).exists():
                t0 = time.perf_counter()
                _compile(out_dir)
                build_seconds = time.perf_counter() - t0
            _lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        return _lib


def function(name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """``name`` from the library with its argument types set (a pointer
    passed without ``c_void_p`` would be cut to 32 bits); returns int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptxas_log() -> str:
    path = build_dir() / "ptxas.log"
    return path.read_text() if path.exists() else ""
