"""What the three wrappers share: argument checks and the launch check."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_dense(name: str, **tensors: torch.Tensor) -> int:
    """All tensors on one CUDA device, of one supported dtype, contiguous.
    Returns the kernels' dtype code.  Raises on anything else: a wrapper
    copies nothing behind the caller's back."""
    first = next(iter(tensors.values()))
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype} not supported "
                        f"(float32, bfloat16)")
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, the kernel "
                             f"takes CUDA tensors only")
        if t.device != first.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected "
                             f"{first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected "
                            f"{first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")
    return DTYPE_CODES[first.dtype]


def check_offset(name: str, q_offset: int, Sq: int) -> int:
    """An attention's ``q_offset`` as the kernels take it: an integer of at
    least 0 whose last query position fits an int32."""
    if int(q_offset) != q_offset or q_offset < 0 or q_offset + Sq >= 2 ** 31:
        raise ValueError(f"{name}: q_offset {q_offset}; the kernel takes "
                         f"0 <= q_offset and q_offset + Sq < 2**31")
    return int(q_offset)


def check_launch(name: str, err: int) -> None:
    """``err`` is the ``cudaGetLastError()`` the C function returned right
    after its launch; a refused launch never runs and no later
    synchronise reports it."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
