"""Wrapper of the CUDA depthwise convolution (``csrc/depthwise_conv.cu``).

Port of ``repro/kernels/depthwise_conv.py``.  ``launches`` counts the
kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _P]


def _pixel_stride(x: torch.Tensor) -> int:
    """Distance between two pixels of a channels-last ``x`` that is dense
    or a channel slice of a dense tensor; raises on any other layout."""
    B, H, W, C = x.shape
    # the first dim that has more than one entry tells the distance
    if W > 1:
        ps = x.stride(2)
    elif H > 1:
        ps = x.stride(1)
    elif B > 1:
        ps = x.stride(0)
    else:
        ps = C
    want = (H * W * ps, W * ps, ps, 1)
    for dim, (size, got, exp) in enumerate(zip(x.shape, x.stride(), want)):
        if size > 1 and got != exp:
            raise ValueError(
                f"depthwise_conv2d: x with shape {tuple(x.shape)} and "
                f"strides {x.stride()} is neither dense channels-last nor "
                f"a channel slice of one (dim {dim})")
    if ps < C:
        raise ValueError(f"depthwise_conv2d: pixel stride {ps} < C={C}")
    return ps


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x: [B,H,W,C] on a CUDA device, dense or a channel slice of a dense
    channels-last tensor; w: [fy,fx,C]; b: [C] -> dense [B,H,W,C] (SAME)."""
    global launches
    if x.dim() != 4 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"depthwise_conv2d: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    B, H, W, C = x.shape
    fy, fx, _ = w.shape
    if w.shape[2] != C or b.shape[0] != C:
        raise ValueError(f"depthwise_conv2d: C={C} but w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    code = check_cuda_dense("depthwise_conv2d", w=w, b=b)
    if not x.is_cuda or x.device != w.device or x.dtype != w.dtype:
        raise ValueError(f"depthwise_conv2d: x is {x.dtype} on {x.device}, "
                         f"w is {w.dtype} on {w.device}")
    ps = _pixel_stride(x)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.function("repro_depthwise_conv2d", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, H, W, C, ps, fy, fx, code,
                 torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise_conv2d", err)
    launches += 1
    return out
