"""Wrapper of the CUDA fused inverted bottleneck (``csrc/fused_ibn.cu``).

Port of ``repro/kernels/fused_ibn.py``.  ``launches`` counts the calls
that launch the kernel (one per call, whether or not the partial sums of
a split F need the second, reducing pass).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# the one tile csrc/fused_ibn.cu is compiled for (BM, BF)
BLOCKS = {"block_m": 64, "block_f": 64}

ACTIVATIONS = {"gelu": 0, "silu": 1, "relu2": 2}

# Output columns one block owns, by Do: the instances csrc/fused_ibn.cu
# is compiled for (its launch() picks the same one).  Wider Do is tiled
# over blockIdx.y by the last.
BLOCK_DO = (64, 96, 160, 320)
# blocks a split F aims at, per SM: a block of 512 threads fills one
BLOCKS_PER_SM = 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def share(z: int, splits: int, f_tiles: int) -> range:
    """The F tiles split ``z`` of ``splits`` walks: contiguous, sizes
    differing by at most one, none empty while splits <= f_tiles (the
    kernel's ``t_lo``/``t_hi``)."""
    return range(z * f_tiles // splits, (z + 1) * f_tiles // splits)


def plan(M: int, F: int, Do: int, sms: int) -> dict:
    """How the kernel runs x [M, D] -> [M, F] -> [M, Do] on a card with
    ``sms`` SMs.  The grid is (row tiles, Do tiles, splits); ``splits`` is
    the split of the F tiles whose grid comes nearest to BLOCKS_PER_SM
    blocks a SM, at least 1 and at most the F tiles.  With splits > 1
    each block writes a float32 partial to a [splits, M, Do] workspace
    (``workspace_bytes``) that a second pass sums in fixed order."""
    row_tiles = _cdiv(M, BLOCKS["block_m"])
    f_tiles = _cdiv(F, BLOCKS["block_f"])
    block_do = next((d for d in BLOCK_DO if Do <= d), BLOCK_DO[-1])
    do_tiles = _cdiv(Do, block_do)
    base = row_tiles * do_tiles
    splits = max(1, min(f_tiles, int(BLOCKS_PER_SM * sms / base + 0.5)))
    return dict(splits=splits, grid=(row_tiles, do_tiles, splits),
                ctas=base * splits, f_tiles=f_tiles, block_do=block_do,
                workspace_bytes=splits * M * Do * 4 if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    splits = plan(M, F, Do, _sms(x.device))["splits"]
    ws = None if splits == 1 else torch.empty(
        (splits, M, Do), dtype=torch.float32, device=x.device)
    fn = _build.function("repro_fused_ibn", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(),
                 None if wg is None else wg.data_ptr(), w2.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 M, D, F, Do, splits, ACTIVATIONS[activation], code,
                 torch.cuda.current_stream().cuda_stream)
    check_launch("fused_ibn", err)
    launches += 1
    return out
