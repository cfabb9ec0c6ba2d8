"""Wrapper of the CUDA fused inverted bottleneck (``csrc/fused_ibn.cu``).

Port of ``repro/kernels/fused_ibn.py``.  ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# the one tile csrc/fused_ibn.cu is compiled for (BM, BF)
BLOCKS = {"block_m": 64, "block_f": 64}

ACTIVATIONS = {"gelu": 0, "silu": 1, "relu2": 2}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]


def fused_ibn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              wg: Optional[torch.Tensor] = None, *,
              activation: str = "gelu") -> torch.Tensor:
    """x: [M, D]; w1/wg: [D, F]; w2: [F, Do] -> [M, Do], all dense and on
    one CUDA device.  Takes the true extents: nothing is padded."""
    global launches
    if activation not in ACTIVATIONS:
        raise ValueError(activation)
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"fused_ibn: shapes {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    M, D = x.shape
    F, Do = w2.shape
    if w1.shape != (D, F) or (wg is not None and wg.shape != (D, F)):
        raise ValueError(f"fused_ibn: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, wg "
                         f"{None if wg is None else tuple(wg.shape)}")
    tensors = dict(x=x, w1=w1, w2=w2)
    if wg is not None:
        tensors["wg"] = wg
    code = check_cuda_dense("fused_ibn", **tensors)
    out = torch.empty((M, Do), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    fn = _build.function("repro_fused_ibn", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(),
                 None if wg is None else wg.data_ptr(), w2.data_ptr(),
                 out.data_ptr(), M, D, F, Do, ACTIVATIONS[activation], code,
                 torch.cuda.current_stream().cuda_stream)
    check_launch("fused_ibn", err)
    launches += 1
    return out
