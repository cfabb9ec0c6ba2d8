"""Wrapper of the CUDA flash attention backward
(``csrc/flash_attention_bwd.cu``).

Port of ``_flash_bwd`` of ``repro/models/attention.py``, the backward of
its ``flash_attention`` custom_vjp: given q, k, v, the forward's output and
its float32 log-sum-exp (``flash_attention.flash_attention(...,
return_lse=True)``) and the output's cotangent, it returns dq, dk and dv in
the input's type.  One call runs three kernels on the current stream (delta
= rowsum(dO . O); dK and dV a 64-key tile a block; dQ a 64-query tile a
block) and counts one launch in ``launches``.  ``FlashAttention`` of
``kernels.flash_attention`` calls it from autograd; nothing else on the
main path does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# the widest head the kernel takes (csrc/flash_attention_bwd.cu's D_MAX)
D_MAX = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 10 + [_L, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_flash_attention_bwd", _ARGTYPES)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """q, out, dout: [B,H,Sq,D]; k, v: [B,H,Sk,D]; lse: [B,H,Sq] float32;
    all dense on one CUDA device, D <= D_MAX -> (dq, dk, dv)."""
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
                        int(window or 0), code,
                        torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention_bwd", err)
    launches += 1
    return dq, dk, dv
