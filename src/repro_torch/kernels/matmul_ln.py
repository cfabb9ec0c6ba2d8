"""Wrapper of the CUDA matmul with a LayerNorm epilogue
(``csrc/matmul_ln.cu``).

Port of ``repro/kernels/matmul_ln.py``.  ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# Template instances of csrc/matmul_ln.cu: block_m is the rows a cluster
# owns.  block_k is accepted from this menu for the lowering's contract and
# runs on the kernel's one K slab, SLAB_K deep, the nearest its tensor-core
# loop uses.  SMEM_BYTES is the budget of the float32 row buffer over the
# whole row, of which each block of a cluster holds its slice.
BLOCK_M = (8, 16, 32, 64)
BLOCK_K = (16, 32, 64)
SLAB_K = 32
SMEM_BYTES = 160 * 1024
# cluster sizes the kernel is launched with (8 is the portable maximum),
# columns of the groups N is split in, the columns a block's step covers by
# block_m (csrc/matmul_ln.cu's Layout::BN), and the share of the SMs a grid
# must cover to count as filling the card
CLUSTER = (1, 2, 4, 8)
GROUP_N = 8
BLOCK_N = {8: 128, 16: 128, 32: 128, 64: 64}
FILL = 0.9


def row_bytes(block_m: int, n: int) -> int:
    """Bytes of the float32 row buffer: block_m rows of N."""
    return block_m * n * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slices(N: int, splits: int) -> list[tuple[int, int]]:
    """The columns [lo, hi) block ``z`` of a cluster owns (the kernel's
    ``s0``/``s1``): contiguous groups of 8, sizes differing by one group
    at most, the last clipped to N."""
    groups = _cdiv(N, GROUP_N)
    return [(min(N, GROUP_N * (z * groups // splits)),
             min(N, GROUP_N * ((z + 1) * groups // splits)))
            for z in range(splits)]


def plan(M: int, N: int, sms: int, *, block_m: int) -> dict:
    """How the kernel runs x [M, K] @ w [K, N] on a card with ``sms``
    SMs.  The grid is (splits, row tiles) in clusters of (splits, 1, 1).
    ``splits`` doubles from 1, up to 8 and to the 8-column groups of N,
    while the grid covers less than FILL of the SMs, or while the
    narrower slices would still hold a whole step of BLOCK_N columns (a
    narrower slice adds blocks but no work to share)."""
    row_tiles = _cdiv(M, block_m)
    groups = _cdiv(N, GROUP_N)
    splits = 1
    while splits < CLUSTER[-1] and 2 * splits <= groups and (
            row_tiles * splits < FILL * sms
            or groups // (2 * splits) * GROUP_N >= BLOCK_N[block_m]):
        splits *= 2
    return dict(splits=splits, grid=(splits, row_tiles),
                ctas=splits * row_tiles, slices=slices(N, splits))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, ctypes.c_float, _I,
             _P]


def matmul_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, *, block_m: int,
              block_k: int, eps: float = 1e-6) -> torch.Tensor:
    """x: [M, K]; w: [K, N]; b, gamma, beta: [N] -> LN(x @ w + b) * gamma
    + beta, [M, N], all dense and on one CUDA device.  ``block_m`` and
    ``block_k`` must be in the kernel's menus, with ``block_m * N * 4``
    within the shared-memory budget."""
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
    splits = plan(M, N, _sms(x.device), block_m=block_m)["splits"]
    fn = _build.function("repro_matmul_ln", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), out.data_ptr(), M, K, N, block_m, splits,
                 eps, code, torch.cuda.current_stream().cuda_stream)
    check_launch("matmul_ln", err)
    launches += 1
    return out
