"""Wrapper of the CUDA flash attention (``csrc/flash_attention.cu``) and its
autograd ``FlashAttention``.

Port of ``repro/kernels/flash_attention.py``'s forward.  Asked for it
(``return_lse``), the forward also writes each row's float32 log-sum-exp,
which ``FlashAttention`` keeps for its backward, the kernel of
``flash_attention_bwd`` (the port of ``repro/models/attention.py``'s
``_flash_bwd``).  ``plan``
picks one of the kernel's two regimes: whole score rows with D split over
a thread-block cluster where the keys fit one block (Sk <= S_MAX), else
the online softmax over KV tiles on the tensor cores (64 query rows a
block, 64-key tiles; D in chunks of ``online_chunk``).  ``launches`` counts the kernel
launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import opcount
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels._launch import check_cuda_dense, check_launch, check_offset

launches = 0

# The online regime's tile (query rows of a block, keys of a KV tile:
# csrc/flash_attention.cu's OQ, OKT), the one tile search.lower emits; the
# whole-row regime takes every lowered shape with Sk <= S_MAX whatever it.
BLOCKS = {"block_q": 64, "block_k": 64}
# Whole rows: keys a launch takes, rows of a row tile (the unit the query
# rows are split in), the cluster sizes (8 is the portable maximum) and
# the dynamic shared memory a block may take (csrc/flash_attention.cu's
# S_MAX, RT, MAX_CLUSTER, SMEM_OPT_IN), and the share of the SMs a grid
# must cover to count as filling the card.  What bounds the blocks an SM
# of this card holds at once: its shared memory, 1 KiB of it reserved a
# block, and the registers (256 threads x at most 128 registers: 2 blocks).
S_MAX = 128
ROW_TILE = 16
CLUSTER = (1, 2, 4, 8)
SMEM_BYTES = 220 * 1024
FILL = 0.9
MAX_ROW_SPLITS = 65535      # the grid's y
SM_SMEM_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
MAX_BLOCKS_SM = 2
_REGIMES = {"online": 0, "rows": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def unit(itemsize: int) -> int:
    """Columns of a slice's unit: one mma depth (8 float32, 16 bf16)."""
    return 8 if itemsize == 4 else 16


def slices(D: int, splits: int, itemsize: int = 4) -> list[tuple[int, int]]:
    """The columns [lo, hi) block ``z`` of a cluster owns (the kernel's
    ``c0``/``c1``): whole units shared out evenly, the last clipped to D."""
    u, units = unit(itemsize), _cdiv(D, unit(itemsize))
    return [(min(D, u * (z * units // splits)),
             min(D, u * ((z + 1) * units // splits)))
            for z in range(splits)]


def row_blocks(Sq: int, row_splits: int) -> list[tuple[int, int]]:
    """The query rows [lo, hi) of each block along the grid's y: whole
    16-row tiles shared out evenly, the last clipped to Sq."""
    tiles = _cdiv(Sq, ROW_TILE)
    return [(ROW_TILE * (y * tiles // row_splits),
             min(Sq, ROW_TILE * ((y + 1) * tiles // row_splits)))
            for y in range(row_splits)]


def smem_bytes(bq: int, Sk: int, wmax: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of a whole-row block (the kernel's
    ``row_shape``): q, k, v and p of the input type, the partial scores,
    the cluster's sums of them and l in float32, with the strides that
    keep the fragment loads free of bank conflicts."""
    nk = ROW_TILE * _cdiv(Sk, ROW_TILE)
    pad_a = 4 if itemsize == 4 else 8
    ldq = wmax + pad_a
    ldv = (wmax + (40 - wmax % 32) % 32 if itemsize == 4
           else wmax + (72 - wmax % 64) % 64)
    return (itemsize * (bq * ldq + nk * ldq + nk * ldv + bq * (nk + pad_a))
            + 4 * (2 * bq * (nk + 8) + bq))


def online_chunk(D: int, itemsize: int = 4) -> int:
    """Columns of D an online block takes at once (the kernel's
    ``online_chunk``, one compiled instance each): all of D up to 256 (128
    in float32), in the narrowest instance that holds it, in registers; a
    wider D in chunks of the widest, the output chunks over the grid's z."""
    widths = (64, 80, 128, 256) if itemsize == 2 else (64, 96, 128)
    return next((w for w in widths if D <= w), widths[-1])


def blocks_per_sm(smem: int) -> int:
    """Whole-row blocks of ``smem`` dynamic bytes an SM holds at once."""
    return min(MAX_BLOCKS_SM,
               SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES))


def plan(BH: int, Sq: int, Sk: int, D: int, sms: int, *,
         itemsize: int = 4) -> dict:
    """How the kernel runs [BH, Sq, D] queries against [BH, Sk, D] keys on
    a card with ``sms`` SMs.

    ``regime`` "rows" (Sk <= S_MAX): a cluster of ``splits`` blocks owns a
    (b, h), a block a slice of D and ``row_splits`` blocks along the
    grid's y share the query rows.  Of every (splits, row_splits) whose
    block fits its shared memory, the one with the fewest waves on the
    card (all blocks resident at once where they fit), then the one whose
    grid comes nearest to filling the card (FILL of the SMs), then with a
    cluster of at most 2 (every block of a cluster sums the partials and
    takes the softmax of its rows again, which shows from 4 blocks on),
    then the one that fills more of the card's resident block slots
    (each block's phases are latency-bound: more of them on a SM hide
    more), then with the smaller cluster, then with even shares (the
    column units and row tiles divide), then with the most blocks.  The
    order is the one under which ``python -m
    repro_torch.profile_flash_attention`` found the fastest split of the
    XCA shapes on the H100, or one within 10 % of it.  Grid (splits * BH,
    row_splits) in clusters of (splits, 1, 1).

    ``regime`` "online" (longer rows, or D too wide for eight slices): the
    grid is (BH, query tiles of BLOCKS["block_q"], ``splits`` chunks of
    ``chunk`` = ``online_chunk`` columns of D), and ``row_splits`` the
    query tiles."""
    u, units, tiles = unit(itemsize), _cdiv(D, unit(itemsize)), \
        _cdiv(Sq, ROW_TILE)
    best = None
    for splits in [c for c in CLUSTER if c <= units] if Sk <= S_MAX else []:
        for rows in range(1, min(tiles, MAX_ROW_SPLITS) + 1):
            smem = smem_bytes(ROW_TILE * _cdiv(tiles, rows), Sk,
                              u * _cdiv(units, splits), itemsize)
            if smem > SMEM_BYTES:
                continue
            ctas = BH * splits * rows
            slots = blocks_per_sm(smem) * sms
            key = (_cdiv(ctas, slots), -min(ctas, FILL * sms),
                   max(splits, 2), -min(ctas, slots), splits,
                   units % splits != 0 or tiles % rows != 0, -ctas)
            if best is None or key < best[0]:
                best = (key, splits, rows)
    if best is None:
        dc = online_chunk(D, itemsize)
        gy, gz = _cdiv(Sq, BLOCKS["block_q"]), _cdiv(D, dc)
        return dict(regime="online", splits=gz, row_splits=gy, chunk=dc,
                    grid=(BH, gy, gz), ctas=BH * gy * gz)
    _, splits, rows = best
    return dict(regime="rows", splits=splits, row_splits=rows,
                grid=(splits * BH, rows), ctas=splits * rows * BH,
                slices=slices(D, splits, itemsize),
                rows=row_blocks(Sq, rows))


@functools.lru_cache(maxsize=4096)
def _launch_plan(BH: int, Sq: int, Sk: int, D: int, sms: int,
                 itemsize: int) -> tuple[int, int, int]:
    p = plan(BH, Sq, Sk, D, sms, itemsize=itemsize)
    return _REGIMES[p["regime"]], p["splits"], p["row_splits"]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_flash_attention", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _I, _I, _I, ctypes.c_float, _I, _I, _I,
             _I, _I, _I, _I, _I, _P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False,
                    q_offset: int = 0):
    """q: [B,H,Sq,D]; k, v: [B,H,Sk,D] (H = full query heads), all dense
    and on one CUDA device -> [B,H,Sq,D].  Any Sq, Sk and D.
    ``q_offset`` (>= 0) is the position of query row 0 less that of key
    row 0, which the causal and window masks read (a sequence shard's
    queries against the keys from the sequence's start).  With
    ``return_lse`` -> (out, lse [B,H,Sq] float32: each row's log-sum-exp of
    the scaled, masked scores, as the reference's ``_flash_fwd`` returns
    it); without, the kernel writes no lse."""
    global launches
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    q_offset = check_offset("flash_attention", q_offset, Sq)
    code = check_cuda_dense("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    scale_ = float(scale) if scale is not None else D ** -0.5
    regime, splits, row_splits = _launch_plan(B * H, Sq, Sk, D, _sms(q.device),
                                              q.element_size())
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None if lse is None else lse.data_ptr(),
                        B * H, Sq, Sk, D, scale_, int(causal),
                        int(window is not None), int(window or 0), q_offset,
                        regime, splits, row_splits, code,
                        torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    launches += 1
    return (out, lse) if return_lse else out


def counted(q, k, v, *, causal: bool, window, q_offset: int = 0, lse: bool = False,
            dout: Optional[torch.Tensor] = None) -> opcount.kernel:
    """``opcount.kernel`` of one call: the forward (with ``lse``, the
    float32 log-sum-exp written too), or with ``dout`` the backward,
    which reads q, k, v, out, lse and dout and writes dq, dk, dv."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    pairs = B * H * opcount.unmasked_pairs(Sq, Sk, causal, window, q_offset) \
        if opcount.counting() else 0
    lse_bytes = B * H * Sq * 4
    if dout is None:
        return opcount.kernel(
            "flash_attention", flops=4 * D * pairs, transcendentals=pairs,
            bytes_accessed=opcount.nbytes(q, k, v) + opcount.nbytes(q)
            + (lse_bytes if lse else 0), reads=(q, k, v))
    return opcount.kernel(
        "flash_attention_bwd", flops=10 * D * pairs, transcendentals=pairs,
        bytes_accessed=2 * opcount.nbytes(q, k, v) + opcount.nbytes(q, dout)
        + lse_bytes, reads=(q, k, v, dout))


class FlashAttention(torch.autograd.Function):
    """Attention with a backward, the port of the reference's
    ``flash_attention`` custom_vjp: the forward keeps (q, k, v, out, lse)
    and the masks, ``q_offset`` among them; the backward returns (dq, dk,
    dv).  On CUDA tensors both launch the
    hand-written kernels (this module's forward with ``return_lse``, then
    ``flash_attention_bwd``); on CPU tensors both run their plain versions,
    ``ref.attention_fwd_lse_ref`` and ``ref.attention_bwd_ref``; on meta
    tensors both return empty tensors of the kernels' shapes (the forward
    keeps an lse of the kernel's).  GQA: the
    caller repeats the KV heads, and autograd sums their dk and dv over the
    group, as ``jnp.repeat``'s VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset=0):
        masks = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        with counted(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     lse=True):
            if q.is_cpu:
                out, lse = ref.attention_fwd_lse_ref(q, k, v, **masks)
            elif q.is_meta:
                out = torch.empty_like(q)
                lse = q.new_empty(q.shape[:3], dtype=torch.float32)
            else:
                out, lse = flash_attention(q, k, v, return_lse=True, **masks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = masks
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        m = ctx.masks
        with counted(q, k, v, causal=m["causal"], window=m["window"],
                     q_offset=m["q_offset"], dout=dout):
            if q.is_meta:
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            else:
                fn = ref.attention_bwd_ref if q.is_cpu else _bwd.flash_attention_bwd
                dq, dk, dv = fn(q, k, v, out, lse, dout.contiguous(), **m)
        return dq, dk, dv, None, None, None, None
