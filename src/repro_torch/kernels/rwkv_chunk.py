"""Wrapper of the CUDA chunked WKV kernel (``csrc/wkv_chunked.cu``).

Port of ``repro/kernels/rwkv_chunk.py``.  ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# facts of csrc/wkv_chunked.cu: V columns a block owns (BV), rows of a
# t-row / score tile (TR = TS), and the shared memory a block may have
SMEM_LIMIT = 232448
_BV, _TILE = 32, 64


def smem_bytes(chunk: int, k: int) -> int:
    """Shared memory of one block at chunk length ``chunk`` and key width
    ``k`` (``layout`` in the source): k and b of the whole chunk (rows
    padded to k + 1), its V tile of v, one 64-row tile of r and of
    scores, the state tile, u and the bonus."""
    kp = k + 1
    ast = max(k, _TILE) + 1
    return 4 * (chunk * kp + (chunk + 1) * kp + chunk * _BV + _TILE * kp
                + _TILE * ast + k * _BV + k + _TILE)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P]


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, logw: [BH, T, K]; v: [BH, T, V]; u: [BH, K]; logw <= 0.
    Returns (out [BH, T, V] in r's dtype, final state [BH, K, V] float32),
    the recurrence run from a zero state in chunks of ``min(chunk, T)``.
    r, k and v share one dtype (float32 or bfloat16); logw and u are each
    float32 or that dtype.  All dense and on one CUDA device."""
    global launches
    if r.dim() != 3 or k.shape != r.shape or logw.shape != r.shape \
            or v.dim() != 3 or v.shape[:2] != r.shape[:2] \
            or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError(f"wkv_chunked: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}")
    BH, T, K = r.shape
    V = v.shape[2]
    if min(BH, T, K, V) == 0 or chunk < 1:
        raise ValueError(f"wkv_chunked: extents BH={BH} T={T} K={K} V={V}, "
                         f"chunk={chunk}; all must be at least 1")
    C = min(chunk, T)
    if smem_bytes(C, K) > SMEM_LIMIT:
        raise ValueError(f"wkv_chunked: chunk {C} at K={K} needs "
                         f"{smem_bytes(C, K)} bytes of shared memory, over "
                         f"the {SMEM_LIMIT} a block may have")
    for key, t in (("logw", logw), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"wkv_chunked: {key} is {t.dtype}; float32 or "
                            f"{r.dtype} (the type of r)")
    code = check_cuda_dense("wkv_chunked", r=r, k=k, v=v)
    side = {}
    for key, t in (("logw", logw), ("u", u)):
        side[key] = check_cuda_dense("wkv_chunked", **{key: t})
        if t.device != r.device:
            raise ValueError(f"wkv_chunked: {key} on {t.device}, expected "
                             f"{r.device}")
    out = torch.empty((BH, T, V), dtype=r.dtype, device=r.device)
    state = torch.empty((BH, K, V), dtype=torch.float32, device=r.device)
    fn = _build.function("repro_wkv_chunked", _ARGTYPES)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), out.data_ptr(), state.data_ptr(), BH, T, K, V,
                 C, code, side["logw"], side["u"],
                 torch.cuda.current_stream().cuda_stream)
    check_launch("wkv_chunked", err)
    launches += 1
    return out, state

