"""Wrapper of the CUDA chunked WKV kernel (``csrc/wkv_chunked.cu``).

Port of ``repro/kernels/rwkv_chunk.py``.  One call launches two kernels on
the current stream: the states pass (from a given initial state or zero,
the state entering every chunk, into a float32 workspace, and the final
state) and the outputs pass (every chunk at once).  ``plan`` picks how each runs for the shape and the card;
the kernel refuses a plan it cannot run.  ``launches`` counts the calls
that launched the kernels.  ``WKVChunked`` is the autograd function around
the forward and its backward (``rwkv_chunk_bwd``, which reads the
forward's workspace of entering states).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import opcount
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv_chunk_bwd as _bwd
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# the chunk at which the kernel is fastest on the H100: in python -m
# repro_torch.profile_wkv's chunk sweep (chunks 16..128, rounds that
# alternate their order) 32 leads 64 by 2 % in every round at RWKV-6's
# served bf16 shape and ties it at RecurrentGemma's K = 1 shape (PERF.md);
# search.lower snaps to it
CHUNK = 32

# facts of csrc/wkv_chunked.cu: the shared memory a block may have; the
# V columns a warp owns in either pass (BVS); the state rows a
# states-pass warp owns (KT), the row pitch of its staged k and cumsum
# (KTP), its slab rows (SLAB) and slabs in flight (STAGES); the exact
# diagonal block (SUB) and tile (TILE) rows, the warps on a tile (wv) and
# the warps a block of the outputs pass
SMEM_LIMIT = 232448
BVS = 32
KT, KTP = 16, 24
SLAB = 32
STAGES = 2
SUB, TILE = 8, 16
WVS = (1, 2)
MAX_WARPS = 8
# the rows an outputs-pass block may own (each a multiple of TILE, at most
# C rounded up to it)
ROW_MENU = (32, 64, 128)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(chunk: int, k: int, *, itemsize: int = 4,
               logw_itemsize: int = 4, wv: int = 1, warps: int = 1,
               rows: int = TILE) -> int:
    """Shared memory of an outputs-pass block (``out_layout`` in the
    source) at chunk length ``chunk`` and key width ``k``: k of the whole
    chunk and the r rows the block owns in the input type (rows padded to
    k rounded up to 8, plus 16 bytes), the decay cumsum of the chunk in
    float32 (and bf16 logw before it), the chunk's V tile of v (BVS wv
    columns plus 32 bytes a row), u, the cumsum's partial totals, and for
    each group of ``wv`` warps its q and its block of A, a TILE each; the
    chunk is rounded up to a TILE.  By default the least a chunk can run
    with in float32 (one warp on one tile): a chunk runs at all where this
    is within SMEM_LIMIT."""
    groups = warps // wv
    kp = _cdiv(k, 8) * 8
    ldk, ldkt = kp + 4, kp + 16 // itemsize
    ldvt = BVS * wv + 32 // itemsize
    cp = _cdiv(chunk, TILE) * TILE
    return (cp * ldkt * itemsize + (cp + 1) * ldk * 4
            + (0 if logw_itemsize == 4 else cp * kp * 2)
            + rows * ldkt * itemsize + groups * TILE * ldk * 4
            + cp * ldvt * itemsize + kp * 4 + 32 * warps * 4
            + groups * TILE * (TILE + 4) * 4)


def states_smem_bytes(itemsize: int, logw_itemsize: int) -> int:
    """Shared memory of a states-pass block (``states_layout``, one warp):
    STAGES stages of SLAB rows of raw k (KT columns in rows of KTP), logw
    (KT columns) and v (BVS columns, padded by 8), and the slab's cumsum
    in float32 (rows of KTP)."""
    return (STAGES * SLAB * (KTP * itemsize + KT * logw_itemsize
                             + (BVS + 8) * itemsize) + 4 * SLAB * KTP)


def outputs_ctas(BH: int, T: int, V: int, C: int, rows: int, wv: int) -> int:
    """Blocks of the outputs pass: (bh, chunk x row tile, V tile)."""
    return BH * _cdiv(T, C) * _cdiv(C, rows) * _cdiv(V, BVS * wv)


def states_ctas(BH: int, K: int, V: int) -> int:
    """Blocks (one warp each) of the states pass: (bh, K tile, V tile)."""
    return BH * _cdiv(K, KT) * _cdiv(V, BVS)


def candidates(BH: int, T: int, K: int, V: int, C: int, itemsize: int = 4,
               logw_itemsize: int = 4) -> list[dict]:
    """Every outputs-pass configuration the kernel can run the shape with:
    ``wv`` (a V tile of BVS wv columns), ``rows`` (from ROW_MENU and C
    rounded up to TILE), ``warps`` (wv times a power of two up to the
    block's tiles), each within SMEM_LIMIT, with its blocks (``ctas``) and
    shared memory."""
    out = []
    cp = _cdiv(C, TILE) * TILE
    for rows in sorted({r for r in ROW_MENU + (cp,) if r % TILE == 0
                        and TILE <= r <= cp}):
        for wv in WVS:
            for groups in (1, 2, 4, 8):
                warps = groups * wv
                if groups > rows // TILE or warps > MAX_WARPS:
                    continue
                smem = smem_bytes(C, K, itemsize=itemsize,
                                  logw_itemsize=logw_itemsize, wv=wv,
                                  warps=warps, rows=rows)
                if smem <= SMEM_LIMIT:
                    out.append(dict(wv=wv, rows=rows, warps=warps, smem=smem,
                                    ctas=outputs_ctas(BH, T, V, C, rows, wv)))
    return out


def plan(BH: int, T: int, K: int, V: int, C: int, itemsize: int = 4, *,
         logw_itemsize: int = 4, sms: int = 132) -> dict:
    """How the outputs pass runs r, k, logw [BH, T, K], v [BH, T, V] at
    chunk C on a card with ``sms`` SMs, fitted to ``python -m
    repro_torch.profile_wkv``'s sweep on the H100 (RWKV-6's served and
    B = 1 x 200 shapes, RecurrentGemma's K = 1, V = 2560): ``rows`` a block
    = the chunk rounded up to a TILE, at most 64, and a V tile of 64
    columns, ``wv`` = 2 warps on a tile that share its scores; a group of
    wv warps for each of up to 4 tiles.  Where the grid does not cover the
    card, the rows a block are halved while they hold two tiles; where the
    block does not fit, one warp a tile (a V tile of 32), then fewer rows.
    The states pass has no choice: one warp for each (bh, K tile, V
    tile)."""
    sz = dict(itemsize=itemsize, logw_itemsize=logw_itemsize)
    cp = _cdiv(C, TILE) * TILE
    rows = min(cp, 64)
    wv = 2
    while rows >= 2 * TILE and outputs_ctas(BH, T, V, C, rows, wv) < sms:
        rows = rows // 2 // TILE * TILE
    warps = wv * min(4, rows // TILE)
    while smem_bytes(C, K, **sz, wv=wv, warps=warps,
                     rows=rows) > SMEM_LIMIT and (wv > 1 or rows > TILE):
        if wv > 1:
            wv = 1
        else:
            rows = max(TILE, rows // 2 // TILE * TILE)
        warps = wv * min(4, rows // TILE)
    return dict(wv=wv, rows=rows, warps=warps,
                smem=smem_bytes(C, K, **sz, wv=wv, warps=warps, rows=rows),
                states_smem=states_smem_bytes(itemsize, logw_itemsize),
                ctas=outputs_ctas(BH, T, V, C, rows, wv),
                states_ctas=states_ctas(BH, K, V))


@functools.lru_cache(maxsize=4096)
def _launch_plan(BH: int, T: int, K: int, V: int, C: int, itemsize: int,
                 logw_itemsize: int, sms: int) -> tuple:
    p = plan(BH, T, K, V, C, itemsize, logw_itemsize=logw_itemsize, sms=sms)
    return tuple(p[key] for key in ("wv", "warps", "rows"))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 9 + [_L] + [_I] * 10 + [_P]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_wkv_chunked", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(BH: int, T: int, K: int, V: int, C: int,
              device: torch.device) -> torch.Tensor:
    """The float32 [BH, ceil(T / C), K, V] the states pass writes the state
    entering each chunk to and the outputs pass reads."""
    return torch.empty((BH, _cdiv(T, C), K, V), dtype=torch.float32,
                       device=device)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, logw: [BH, T, K]; v: [BH, T, V]; u: [BH, K]; logw <= 0;
    ``state`` the initial state, float32 [BH, K, V] (None: zero).
    Returns (out [BH, T, V] in r's dtype, final state [BH, K, V] float32),
    the recurrence run from ``state`` in chunks of ``min(chunk, T)``.
    r, k and v share one dtype (float32 or bfloat16); logw and u are each
    float32 or that dtype.  All dense and on one CUDA device."""
    return forward_with_states(r, k, v, logw, u, chunk=chunk, state=state)[:2]


def forward_with_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                        state: Optional[torch.Tensor] = None):
    """``wkv_chunked``'s launch -> (out, final state, the float32
    ``workspace`` of the states entering each chunk, ``state`` the first,
    which the backward reads)."""
    global launches
    if r.dim() != 3 or k.shape != r.shape or logw.shape != r.shape \
            or v.dim() != 3 or v.shape[:2] != r.shape[:2] \
            or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError(f"wkv_chunked: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}")
    BH, T, K = r.shape
    V = v.shape[2]
    if min(BH, T, K, V) == 0 or chunk < 1:
        raise ValueError(f"wkv_chunked: extents BH={BH} T={T} K={K} V={V}, "
                         f"chunk={chunk}; all must be at least 1")
    C = min(chunk, T)
    if smem_bytes(C, K) > SMEM_LIMIT:
        raise ValueError(f"wkv_chunked: chunk {C} at K={K} needs "
                         f"{smem_bytes(C, K)} bytes of shared memory, over "
                         f"the {SMEM_LIMIT} a block may have")
    for key, t in (("logw", logw), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"wkv_chunked: {key} is {t.dtype}; float32 or "
                            f"{r.dtype} (the type of r)")
    code = check_cuda_dense("wkv_chunked", r=r, k=k, v=v)
    if state is not None:
        check_cuda_dense("wkv_chunked", state=state)
        if state.shape != (BH, K, V) or state.dtype != torch.float32 \
                or state.device != r.device:
            raise ValueError(f"wkv_chunked: state {tuple(state.shape)} "
                             f"{state.dtype} on {state.device}, expected "
                             f"float32 {(BH, K, V)} on {r.device}")
    side = {}
    for key, t in (("logw", logw), ("u", u)):
        side[key] = check_cuda_dense("wkv_chunked", **{key: t})
        if t.device != r.device:
            raise ValueError(f"wkv_chunked: {key} on {t.device}, expected "
                             f"{r.device}")
    out = torch.empty((BH, T, V), dtype=r.dtype, device=r.device)
    final = torch.empty((BH, K, V), dtype=torch.float32, device=r.device)
    ws = workspace(BH, T, K, V, C, r.device)
    p = _launch_plan(BH, T, K, V, C, r.element_size(), logw.element_size(),
                     _sms(r.device))
    with torch.cuda.device(r.device):
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(),
                        None if state is None else state.data_ptr(),
                        out.data_ptr(), final.data_ptr(), ws.data_ptr(), BH, T, K, V, C,
                        code, side["logw"], side["u"], *p,
                        torch.cuda.current_stream().cuda_stream)
    check_launch("wkv_chunked", err)
    launches += 1
    return out, final, ws


def counted(r, k, v, logw, u, state, chunk: int, *, dout=None, dstate=None
            ) -> opcount.kernel:
    """``opcount.kernel`` of one call: the forward (reads r, k, v, logw,
    u and the initial state where given, writes out and the float32 final
    state; one exp a decay), or with ``dout`` the backward (reads those,
    dout and dstate, writes dr, dk, dv, dlogw, du and dS0 where a state
    was given)."""
    BH, T, K = r.shape
    V = v.shape[2]
    ins = opcount.nbytes(r, k, v, logw, u, state)
    if dout is None:
        return opcount.kernel(
            "wkv_chunked", flops=opcount.wkv_flops(BH, T, K, V, chunk),
            transcendentals=BH * T * K, reads=(r, k, v, logw, u, state),
            bytes_accessed=ins + BH * T * V * r.element_size() + BH * K * V * 4)
    return opcount.kernel(
        "wkv_chunked_bwd", flops=opcount.wkv_bwd_flops(BH, T, K, V, chunk),
        transcendentals=BH * T * K, reads=(r, k, v, logw, u, state, dout, dstate),
        bytes_accessed=2 * ins + opcount.nbytes(dout, dstate))


def meta_outputs(r: torch.Tensor, v: torch.Tensor):
    """(out, final state) of the kernel's shapes on the meta device."""
    BH, T, K = r.shape
    return (r.new_empty((BH, T, v.shape[2])),
            r.new_empty((BH, K, v.shape[2]), dtype=torch.float32))


class WKVChunked(torch.autograd.Function):
    """The chunked WKV with a backward: (r, k, v, logw, u, state, chunk) ->
    (out, final state), as ``ops.wkv_chunked`` (``state`` the initial
    state or None); the backward takes the cotangents of both (None for an
    unused one) and returns (dr, dk, dv, dlogw, du) and, where a state was
    given, its gradient dS0.
    On CUDA tensors the forward is this module's kernel, whose workspace of
    entering states (16.8 MB at 128 x 512 x 64 x 64, chunk 64) is saved for
    ``rwkv_chunk_bwd.wkv_chunked_bwd``; on CPU tensors the forward is
    ``ref.wkv_ref`` and the backward ``ref.wkv_bwd_ref``, the kernel's
    algorithm in torch; on meta tensors both return empty tensors of the
    kernels' shapes, the forward keeping a workspace of the kernel's.  The model's ``u.repeat(B, 1)`` sums du over the
    batch through autograd."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk):
        ctx.set_materialize_grads(False)
        with counted(r, k, v, logw, u, state0, chunk):
            if r.is_cpu:
                (out, state), ws = ref.wkv_ref(r, k, v, logw, u, state0), None
            elif r.is_meta:
                (out, state), ws = meta_outputs(r, v), workspace(
                    r.shape[0], r.shape[1], r.shape[2], v.shape[2],
                    min(chunk, r.shape[1]), r.device)
            else:
                # refuse before the launch a chunk the backward cannot run
                _bwd.check_chunk(min(chunk, r.shape[1]), r.shape[2], v.shape[2])
                out, state, ws = forward_with_states(r, k, v, logw, u, chunk=chunk,
                                                     state=state0)
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u, state, ws, state0)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, logw, u, state, ws, state0 = ctx.saved_tensors
        with counted(r, k, v, logw, u, state0, ctx.chunk,
                     dout=v if dout is None else dout, dstate=dstate):
            if dout is None:
                dout = torch.zeros(v.shape, dtype=r.dtype, device=r.device)
            dout = dout.contiguous()
            if dstate is not None:
                dstate = dstate.float().contiguous()
            if r.is_cpu:
                grads = ref.wkv_bwd_ref(r, k, v, logw, u, dout, dstate,
                                        chunk=ctx.chunk, state=state0)
            elif r.is_meta:
                grads = (*(torch.empty_like(t) for t in (r, k, v, logw, u)),
                         None if state0 is None else torch.empty_like(state0))
            else:
                grads = _bwd.wkv_chunked_bwd(r, k, v, logw, u, dout, ws,
                                             chunk=ctx.chunk, dstate=dstate,
                                             state=state, ds0=state0 is not None)
        return (*grads[:5], grads[5] if state0 is not None else None, None)
