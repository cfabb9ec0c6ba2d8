"""Wrapper of the CUDA flash attention (``csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py``, forward only.  ``launches``
counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# the one tile csrc/flash_attention.cu is compiled for (BQ, BK)
BLOCKS = {"block_q": 16, "block_k": 32}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _L, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I,
             _P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,H,Sk,D] (H = full query heads), all dense
    and on one CUDA device -> [B,H,Sq,D].  Any Sq, Sk and D."""
    global launches
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    code = check_cuda_dense("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    scale_ = float(scale) if scale is not None else D ** -0.5
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, Sq, Sk, D, scale_, int(causal),
                 int(window is not None), int(window or 0), code,
                 torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    launches += 1
    return out
