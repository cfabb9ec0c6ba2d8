"""Wrapper of the CUDA AdamW update (``csrc/adamw.cu``).

It replaces no Pallas kernel: it is the port's counterpart of the loop XLA
fuses out of the reference's per-leaf update ``upd``
(``repro/optim/adamw.py:47``) under the launcher's ``jit(train_step,
donate_argnums=(0, 1))``, the clip's scale of the gradient folded in.  One
float32 leaf a call, in place in p, m and v, in one pass of 28 bytes a
parameter; ``ref.adamw_ref`` is its plain version, which it equals bit for
bit on the card (the source says how).  The rate, the bias corrections and
the clip's scale are 0-d float32 tensors on the leaf's device, read by the
kernel from device memory, so that a captured step reads each step's.
``launches`` counts the calls that launch the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_launch

launches = 0

_P, _L, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _I, _P]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(leaf: torch.Tensor, **tensors: Optional[torch.Tensor]) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != leaf.device:
            raise ValueError(f"adamw: {key} is on {t.device}, the kernel takes "
                             f"CUDA tensors on {leaf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"adamw: {key} is {t.dtype}; the kernel takes "
                            f"float32 leaves and scalars only")
        if not t.is_contiguous():
            raise ValueError(f"adamw: {key} is not contiguous (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
                 lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                 scale: Optional[torch.Tensor], b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of the leaf ``p`` (module docstring), written into
    ``p``, ``m`` and ``v``.  All four of one shape, dense, float32, on one
    CUDA device; ``lr``, ``bc1``, ``bc2`` and ``scale`` (None: no clip) one
    float32 element each on that device.  Raises on anything else."""
    global launches
    _check(p, p=p, g=g, m=m, v=v, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"adamw: shapes p {tuple(p.shape)}, g {tuple(g.shape)}, "
                         f"m {tuple(m.shape)}, v {tuple(v.shape)}")
    for key, t in (("lr", lr), ("bc1", bc1), ("bc2", bc2), ("scale", scale)):
        if t is not None and t.numel() != 1:
            raise ValueError(f"adamw: {key} has {t.numel()} elements, expected one")
    if p.numel() == 0:
        return
    fn = _build.function("repro_adamw", _ARGTYPES)
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), lr.data_ptr(),
                 bc1.data_ptr(), bc2.data_ptr(), None if scale is None else scale.data_ptr(),
                 p.numel(), b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay,
                 _sms(p.device), torch.cuda.current_stream().cuda_stream)
    check_launch("adamw", err)
    launches += 1
