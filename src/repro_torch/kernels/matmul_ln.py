"""Wrapper of the CUDA matmul with a LayerNorm epilogue
(``csrc/matmul_ln.cu``).

Port of ``repro/kernels/matmul_ln.py``.  ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# template instances of csrc/matmul_ln.cu and its shared-memory budget for
# the float32 row buffer (SMEM_BUDGET there)
BLOCK_M = (8, 16, 32, 64)
BLOCK_K = (16, 32, 64)
SMEM_BYTES = 160 * 1024


def row_bytes(block_m: int, n: int) -> int:
    """Bytes of the float32 row buffer: block_m rows of N."""
    return block_m * n * 4


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, ctypes.c_float, _I,
             _P]


def matmul_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, *, block_m: int,
              block_k: int, eps: float = 1e-6) -> torch.Tensor:
    """x: [M, K]; w: [K, N]; b, gamma, beta: [N] -> LN(x @ w + b) * gamma
    + beta, [M, N], all dense and on one CUDA device.  ``block_m`` and
    ``block_k`` select the kernel's template instance and must be in its
    menu, with ``block_m * N * 4`` within the shared-memory budget."""
    global launches
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or any(t.shape != (w.shape[1],) for t in (b, gamma, beta)):
        raise ValueError(f"matmul_ln: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if block_m not in BLOCK_M or block_k not in BLOCK_K:
        raise ValueError(f"matmul_ln: block_m={block_m}, block_k={block_k}; "
                         f"the kernel is built for block_m in {BLOCK_M}, "
                         f"block_k in {BLOCK_K}")
    if row_bytes(block_m, N) > SMEM_BYTES:
        raise ValueError(f"matmul_ln: a row buffer of block_m={block_m} x "
                         f"N={N} float32 is {row_bytes(block_m, N)} bytes, "
                         f"over the {SMEM_BYTES}-byte budget")
    code = check_cuda_dense("matmul_ln", x=x, w=w, b=b, gamma=gamma,
                            beta=beta)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    fn = _build.function("repro_matmul_ln", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), out.data_ptr(), M, K, N, block_m, block_k,
                 eps, code, torch.cuda.current_stream().cuda_stream)
    check_launch("matmul_ln", err)
    launches += 1
    return out
