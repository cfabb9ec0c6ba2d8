"""Wrapper of the CUDA flash attention backward
(``csrc/flash_attention_bwd.cu``).

Port of ``_flash_bwd`` of ``repro/models/attention.py``, the backward of
its ``flash_attention`` custom_vjp: given q, k, v, the forward's output and
its float32 log-sum-exp (``flash_attention.flash_attention(...,
return_lse=True)``) and the output's cotangent, it returns dq, dk and dv in
the input's type.  One call runs three kernels on the current stream (delta
= rowsum(dO . O); dK and dV of ``keys`` keys a block, walking the query
tiles they see; dQ of a 64-query tile a block, walking its key tiles; both
walks over a ``stages``-deep ``cp.async`` ring) and counts one launch in
``launches``.  ``PLAN`` says which compiled instance a head takes.
``FlashAttention`` of ``kernels.flash_attention`` calls it from autograd;
nothing else on the main path does.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch, check_offset

launches = 0

# the widest head the kernel takes (csrc/flash_attention_bwd.cu's D_MAX)
D_MAX = 256

# csrc/flash_attention_bwd.cu's PLAN, which a CPU test holds equal to this:
# (dtype, widest D of the row) -> (keys a dK / dV block, stages of the
# cp.async ring, D chunk); a head takes the first row of its dtype that is
# as wide.  Keys: 16 a warp; 128 halves the re-reads of q, dO, lse and delta
# where registers and shared memory allow.  Set from
# ``python -m repro_torch.profile_flash_attention_bwd``'s sweep (H100 80GB
# HBM3): two stages match or beat three at every trained shape (three cost
# the D 128 dQ block its second block a SM), 128 keys beat 64 at D 128 and
# 256 and tie at D 64, and 64 keys are ~6 % faster at h2o-danube's D 80.
# float32: measured at D 64 only (128 keys ~3 % faster); the wider rows keep
# 64 keys.
PLAN = {
    ("bfloat16", 64): (128, 2, 64),
    ("bfloat16", 80): (64, 2, 80),
    ("bfloat16", 128): (128, 2, 128),
    ("bfloat16", 256): (128, 2, 128),
    ("float32", 64): (128, 2, 64),
    ("float32", 80): (64, 2, 80),
    ("float32", 128): (64, 2, 64),
    ("float32", 256): (64, 2, 64),
}
# the kernel's TQ (queries of a dK / dV ring tile and of a dQ block), TK
# (keys of a dQ ring tile) and SMEM_OPT_IN (dynamic shared memory a block
# may take)
TILE_Q = 64
TILE_K = 64
SMEM_BYTES = 220 * 1024
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def instance(D: int, dtype: torch.dtype) -> dict:
    """The compiled instance a head of D in ``dtype`` takes: PLAN's row
    (``d_max``), its keys, stages and chunk, the output chunks (the grid's
    z) and the dynamic shared memory of the dK / dV and dQ blocks."""
    name = _DTYPES[dtype]
    d_max = min(w for (n, w) in PLAN if n == name and w >= D)
    keys, stages, chunk = PLAN[name, d_max]
    return dict(dtype=name, d_max=d_max, keys=keys, stages=stages, chunk=chunk,
                chunks=-(-D // chunk), fixed_chunks=row_chunks(name, d_max),
                **smem_bytes(D, dtype, keys=keys, stages=stages, chunk=chunk))


def row_chunks(name: str, d_max: int) -> int:
    """The chunks of D every head of PLAN's row (name, d_max) has, where
    they are one number, else 0: the instances' compile-time NC (the
    kernel's row_chunks)."""
    chunk = PLAN[name, d_max][2]
    lo = max((w for (n, w) in PLAN if n == name and w < d_max), default=0)
    first, last = (lo + chunk) // chunk, -(-d_max // chunk)
    return last if first == last else 0


def smem_bytes(D: int, dtype: torch.dtype, *, keys: int, stages: int,
               chunk: int) -> dict:
    """Dynamic shared memory of the two blocks (the kernel's dkv_smem and
    dq_smem): rows padded to ``chunk`` + 8 bf16 / + 4 float32 elements;
    the dK / dV block keeps K and V of its keys (every chunk) and rings
    (q, dO) chunks of TILE_Q rows with their lse and delta; the dQ block
    keeps q and dO (every chunk) and rings (K, V) chunks of TILE_K rows."""
    item = torch.tensor([], dtype=dtype).element_size()
    ld, nc = chunk + (8 if item == 2 else 4), -(-D // chunk)
    return dict(smem_dkv=item * ld * (2 * keys * nc + stages * 2 * TILE_Q)
                + 4 * stages * 2 * TILE_Q,
                smem_dq=item * ld * (2 * TILE_Q * nc + stages * 2 * TILE_K))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 10 + [_L, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P]


def ptxas(log: str) -> dict:
    """``ptxas -v``'s registers and spill bytes of each dK / dV and dQ
    kernel instance in a build log: "dkv bfloat16 80 128 2 1" (chunk, keys,
    stages, compile-time chunks or 0) and "dq bfloat16 80 2 1" (chunk,
    stages, chunks) -> (registers, spill stores, spill loads)."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            if m.group(1) != name:
                spill = (0, 0)
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        inst = name and re.search(
            r"attn_bwd_(dkv|dq)_kernelI(f|13__nv_bfloat16)((?:Li\d+E)+)", name)
        if m and inst:
            dtype = "float32" if inst.group(2) == "f" else "bfloat16"
            args = " ".join(re.findall(r"Li(\d+)E", inst.group(3)))
            out[f"{inst.group(1)} {dtype} {args}"] = (int(m.group(1)), *spill)
    return dict(sorted(out.items()))


def ptxas_of(inst: dict, log: str) -> dict:
    """The registers and spills of ``instance``'s two kernels in ``log``:
    {"dkv": (registers, spill stores, spill loads), "dq": ...}, None where
    the log does not have one."""
    got = ptxas(log)
    c, k, st, d = inst["chunk"], inst["keys"], inst["stages"], inst["dtype"]
    nc = inst["fixed_chunks"]
    return dict(dkv=got.get(f"dkv {d} {c} {k} {st} {nc}"), dq=got.get(f"dq {d} {c} {st} {nc}"))


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_flash_attention_bwd", _ARGTYPES)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0):
    """q, out, dout: [B,H,Sq,D]; k, v: [B,H,Sk,D]; lse: [B,H,Sq] float32;
    all dense on one CUDA device, D <= D_MAX -> (dq, dk, dv).  The masks
    as the forward's, ``q_offset`` among them."""
    global launches
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3] \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if D > D_MAX:
        raise ValueError(f"flash_attention_bwd: head dim {D}, the kernel takes "
                         f"D <= {D_MAX}")
    q_offset = check_offset("flash_attention_bwd", q_offset, Sq)
    code = check_cuda_dense("flash_attention_bwd", q=q, k=k, v=v, out=out,
                            dout=dout)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, expected a dense "
                         f"float32 {tuple(q.shape[:3])} on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale_ = float(scale) if scale is not None else D ** -0.5
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, Sq,
                        Sk, D, scale_, int(causal), int(window is not None),
                        int(window or 0), q_offset, code,
                        torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention_bwd", err)
    launches += 1
    return dq, dk, dv
