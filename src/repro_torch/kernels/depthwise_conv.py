"""Wrapper of the CUDA depthwise convolution (``csrc/depthwise_conv.cu``).

Port of ``repro/kernels/depthwise_conv.py``.  ``plan`` picks the tile a
block owns for the shape and the card; the kernel refuses a plan it
cannot run.  ``launches`` counts the kernel launches made through this
wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# csrc/depthwise_conv.cu's SW (outputs along W a thread computes),
# MAX_THREADS, MAX_TAPS and SMEM_OPT_IN
SW = 4
MAX_THREADS = 256
MAX_TAPS = 15 * 15
SMEM_BYTES = 227 * 1024
# the tile heights and widths plan() tries (each clipped to the image), and
# the fewest threads a block it picks has: one warp
TH_MENU = (1, 2, 4, 8, 16, 32)
TW_MENU = (4, 8, 16, 32, 64)
MIN_THREADS = 32
# What bounds the blocks an SM of this card holds at once: its shared
# memory (1 KiB of it reserved a block), its threads, its block slots and
# its registers, of which a thread is taken to use REGS (ptxas gives the
# instances 32-64).
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
MAX_BLOCKS_SM = 32
MAX_THREADS_SM = 2048
REGS_SM = 65536
REGS = 64
# plan()'s time model, fitted to ``python -m repro_torch.profile_depthwise``
# on the H100: a block's latency (copy in, taps, store), what each copy a
# thread issues adds to it, the card's memory rate shared out over its SMs,
# and the bytes a pixel's chunk costs, rounded up to 64 (two 32-byte
# sectors)
LATENCY_US = 2.0
COPY_US = 0.1
SM_BYTES_US = 3.35e12 / 132 / 1e6
LINE = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _I,
             _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vector_width(C: int, itemsize: int, align: int) -> int:
    """Channels a thread reads and copies as one vector (CV): the most of
    4, 2, 1 that divides C and whose bytes divide ``align``, the largest
    power of two (at most 16) that divides the addresses of x and w and
    x's pixel stride in bytes."""
    for cv in (4, 2):
        if C % cv == 0 and align % (cv * itemsize) == 0:
            return cv
    return 1


def alignment(x: torch.Tensor, w: torch.Tensor, ps: int) -> int:
    """The ``align`` of ``vector_width`` for ``x`` with pixel stride ``ps``
    and weights ``w``."""
    return math.gcd(x.data_ptr(), w.data_ptr(), ps * x.element_size(), 16)


def chunk_widths(C: int, cv: int) -> list[int]:
    """Every channel chunk CB the kernel may take for C channels: C split
    into n chunks of ceil(C / n) channels rounded up to a multiple of CV,
    keeping only those whose last chunk is at least half full."""
    units, out = C // cv, []
    for n in range(1, units + 1):
        cb = cv * _cdiv(units, n)
        last = C - (_cdiv(C, cb) - 1) * cb
        if 2 * last >= cb and cb not in out:
            out.append(cb)
    return out


def row_pitch(pw: int, cb: int, cv: int, itemsize: int) -> int:
    """Elements between two rows of the halo tile in shared memory (the
    kernel's ``row_pitch``): pw pixels of cb channels, padded so that the
    next row starts cb / cv vectors further on modulo a 128-byte bank
    cycle, as if the rows were one pixel long."""
    nb, g = 128 // (cv * itemsize), cb // cv
    return cv * (pw * g + (g - pw * g) % nb)


def smem_bytes(th: int, tw: int, cb: int, fy: int, fx: int,
               itemsize: int, cv: int) -> int:
    """Dynamic shared memory of a block: the chunk's weights and the halo
    tile, in the input type."""
    return itemsize * (fy * fx * cb
                       + (th + fy - 1) * row_pitch(tw + fx - 1, cb, cv,
                                                   itemsize))


def blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` dynamic bytes an SM
    holds at once."""
    warps = _cdiv(threads, 32)
    return max(1, min(MAX_BLOCKS_SM, MAX_THREADS_SM // (32 * warps),
                      SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES),
                      REGS_SM // (REGS * 32 * warps)))


def _menu(menu: tuple[int, ...], extent: int, step: int = 1) -> list[int]:
    return sorted({min(t, step * _cdiv(extent, step)) for t in menu})


def candidates(B: int, H: int, W: int, C: int, fy: int, fx: int, sms: int,
               *, itemsize: int = 4, align: int = 16) -> list[dict]:
    """Every tile the kernel can run this shape with, with what plan()
    weighs: the blocks (``ctas``), the waves they take on ``sms`` SMs, and
    ``est_us``, a model of the launch's time: per wave a block's latency
    and its threads' copies (weights and halo), then the bytes an SM
    stages and stores (each pixel's chunk rounded up to LINE bytes) over
    its share of the memory rate."""
    cv = vector_width(C, itemsize, align)
    out = []
    for cb in chunk_widths(C, cv):
        chunks = _cdiv(C, cb)
        row_bytes = LINE * _cdiv(cb * itemsize, LINE)
        for th in _menu(TH_MENU, H):
            for tw in _menu(TW_MENU, W, SW):
                threads = cb // cv * (tw // SW) * th
                smem = smem_bytes(th, tw, cb, fy, fx, itemsize, cv)
                if threads > MAX_THREADS or smem > SMEM_BYTES:
                    continue
                ctas = B * _cdiv(H, th) * _cdiv(W, tw) * chunks
                per_sm = _cdiv(ctas, sms)
                waves = _cdiv(per_sm, blocks_per_sm(threads, smem))
                halo = (th + fy - 1) * (tw + fx - 1)
                copies = _cdiv((halo + fy * fx) * (cb // cv), threads)
                moved = per_sm * row_bytes * (halo + th * tw)
                est = waves * (LATENCY_US + copies * COPY_US) \
                    + moved / SM_BYTES_US
                out.append(dict(th=th, tw=tw, cb=cb, cv=cv, ctas=ctas,
                                threads=threads, smem=smem, waves=waves,
                                est_us=est))
    return out


def plan(B: int, H: int, W: int, C: int, fy: int, fx: int, sms: int, *,
         itemsize: int = 4, align: int = 16) -> dict:
    """How the kernel runs x [B, H, W, C] under an (fy, fx) kernel on a
    card with ``sms`` SMs: a block owns ``th`` x ``tw`` output pixels x
    ``cb`` channels of one image, ``cv`` channels a thread; ``ctas``
    blocks, ``smem`` dynamic bytes each.  Of the ``candidates`` with at
    least MIN_THREADS threads (where the shape has any): where blocks of
    that size can cover every SM, one whose grid does; then the least
    ``est_us``; then the most blocks.  A shape too small to cover the card
    takes the tile of least ``est_us`` outright: there, more and smaller
    blocks only repeat more of the halo (at 1 x 8 x 8 x 304 under 9 x 9,
    the 4 x 4 tiles that give the most one-warp blocks, 40, ran 1.36x
    slower than the 8 x 8 tiles on 38 blocks that this picks, in the sweep
    of ``python -m repro_torch.profile_depthwise`` on the H100).  Grid
    (tiles, channel chunks, B)."""
    if fy * fx > MAX_TAPS:
        raise ValueError(f"depthwise_conv2d: {fy}x{fx} kernel, at most "
                         f"{MAX_TAPS} taps")
    tiles = candidates(B, H, W, C, fy, fx, sms, itemsize=itemsize,
                       align=align)
    tiles = [p for p in tiles if p["threads"] >= MIN_THREADS] or tiles
    fills = max(p["ctas"] for p in tiles) >= sms
    return min(tiles, key=lambda p: (-min(p["ctas"], sms) if fills else 0,
                                     round(p["est_us"], 6), -p["ctas"]))


@functools.lru_cache(maxsize=4096)
def _launch_plan(B: int, H: int, W: int, C: int, fy: int, fx: int, sms: int,
                 itemsize: int, align: int) -> tuple[int, int, int, int]:
    p = plan(B, H, W, C, fy, fx, sms, itemsize=itemsize, align=align)
    return p["th"], p["tw"], p["cb"], p["cv"]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_depthwise_conv2d", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    th, tw, cb, cv = _launch_plan(B, H, W, C, fy, fx, _sms(x.device),
                                  x.element_size(), alignment(x, w, ps))
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), B, H, W, C, ps, fy, fx, th, tw, cb,
                        cv, code, torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise_conv2d", err)
    launches += 1
    return out
