"""Wrapper of the CUDA backward of the chunked WKV
(``csrc/wkv_chunked_bwd.cu``).

It replaces no Pallas kernel: it computes the VJP that ``jax.grad`` takes
of the reference's jnp ``wkv_chunked`` (``repro/models/rwkv6.py:100``), the
form the JAX package trains through.  Given r, k, v, logw, u, the output's
cotangent, the forward kernel's float32 workspace of the states entering
each chunk (``rwkv_chunk.forward_with_states``) and optionally the final
state's cotangent, it returns dr, dk, dv, dlogw and du, each in its input's type,
and, asked for it (a forward from a given initial state), dS0 in float32: the
reverse states pass's gradient entering chunk 0.
One call runs three kernels on the current stream (the reverse states
pass; the gradients pass, one block a chunk with its tiles resident or,
where that does not fit, one block a 16-row tile, as ``plan`` says; the
finishing pass of dlogw and du) and counts one launch in ``launches``.
``rwkv_chunk.WKVChunked`` calls it from autograd; nothing else on the
main path does.  ``ref.wkv_bwd_ref`` is its plain version, by the same
algorithm.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_dense, check_launch

launches = 0

# facts of csrc/wkv_chunked_bwd.cu: the shared memory a block may have, the
# rows of a gradients-pass tile, the warps of a tile-instance block and of
# a chunk-instance group (one tile's rows)
SMEM_LIMIT = 232448
TILE = 16
WARPS = 4
GROUP_WARPS = 4

# csrc/wkv_chunked_bwd.cu's PLAN, which a CPU test holds equal to this:
# (instance, widest chunk (C rounded up to TILE), widest K, widest V; 0 for
# any).  A call takes the first row that holds its (C, K, V) and whose
# block's shared memory is within SMEM_LIMIT.  "chunk": one block a chunk,
# its tiles resident (a group of GROUP_WARPS warps a tile, each warp 16 of
# the K and V columns in its accumulators: up to 64 rows, K, V <= 64);
# "tiles": one block a tile, any (C, K, V) whose tile layout fits.
PLAN = (("chunk", 64, 64, 64), ("tiles", 0, 0, 0))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(C: int, K: int, V: int, *, instance: str = "tiles",
               itemsize: int = 4) -> int:
    """Shared memory of a gradients-pass block of ``instance`` (the
    source's ``grad_layout`` and ``chunk_layout``).  Rows of K are padded to
    kp = K rounded up to 8, of V to vp; cp = C rounded up to a TILE.

    "tiles", all float32: the chunk's cumsum (cp + 1 rows of kp + 4),
    seven TILE-row arrays of that width and four of vp + 4, two TILE x
    (TILE + 4) blocks, two [K, V] tiles (the entering state and the
    leaving state's gradient), u, two TILE-vectors and the cumsum's partial
    totals.

    "chunk": the chunk's r, k (cp rows of kp + 16 bytes) and v, dout (of vp
    + 16 bytes) in the inputs' type (``itemsize`` bytes); float32: the
    cumsum, S_c and G' (kp rows of vp + 4), every tile's Q (cp rows of kp +
    4), each tile's blocks dA and A (two TILE x (cp + 4)), its diagonal
    block (TILE x (TILE + 4)) and its exact blocks' dr' and dk' (two TILE
    x (kp + 4)), u, two factors a row, the cumsum's partial totals (one a
    thread, or kp) and two totals a tile and column."""
    kp, vp = _cdiv(K, 8) * 8, _cdiv(V, 8) * 8
    ldk, ldv = kp + 4, vp + 4
    cp = _cdiv(C, TILE) * TILE
    if instance == "tiles":
        floats = ((cp + 1) * ldk + 7 * TILE * ldk + 4 * TILE * ldv
                  + 2 * TILE * (TILE + 4) + 2 * kp * ldv + kp + 2 * TILE
                  + max(kp, 32 * WARPS))
        return 4 * floats
    if instance != "chunk":
        raise ValueError(f"wkv_chunked_bwd: no instance {instance!r}")
    groups = cp // TILE
    inputs = itemsize * cp * 2 * ((kp + 16 // itemsize) + (vp + 16 // itemsize))
    floats = ((cp + 1) * ldk + 2 * kp * ldv + cp * ldk
              + groups * TILE * (2 * (cp + 4) + TILE + 4 + 2 * ldk) + kp + 2 * cp
              + max(kp, 32 * GROUP_WARPS * groups) + 2 * groups * kp)
    return inputs + 4 * floats


def plan(C: int, K: int, V: int, itemsize: int = 4) -> Optional[dict]:
    """The gradients-pass instance a call at chunk C (C <= T), K, V and
    inputs of ``itemsize`` bytes takes (PLAN's first row that holds it and
    fits), or None: its name, its block's shared memory and its partial
    rows a chunk (xpart / upart)."""
    cp = _cdiv(C, TILE) * TILE
    for name, c_max, k_max, v_max in PLAN:
        if (c_max and cp > c_max) or (k_max and K > k_max) \
                or (v_max and V > v_max):
            continue
        smem = smem_bytes(C, K, V, instance=name, itemsize=itemsize)
        if smem <= SMEM_LIMIT:
            return dict(instance=name, smem=smem,
                        parts=1 if name == "chunk" else cp // TILE)
    return None


def check_chunk(C: int, K: int, V: int, itemsize: int = 4) -> dict:
    """The plan of chunk C at K, V; raises ValueError where the backward
    cannot run it."""
    got = plan(C, K, V, itemsize)
    if got is None:
        raise ValueError(f"wkv_chunked_bwd: chunk {C} at K={K}, V={V} needs "
                         f"{smem_bytes(C, K, V)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may have")
    return got


def ptxas(log: str) -> dict:
    """``ptxas -v``'s registers and spill bytes of each gradients-pass
    instance in a build log: "chunk float32", "tiles bfloat16", ... ->
    (registers, spill stores, spill loads); a source with one kernel of the
    tile layout, ``wkv_grads_kernel``, gives "tiles" rows."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            if m.group(1) != name:
                spill = (0, 0)
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        inst = name and re.search(r"wkv_grads_(chunk_|tile_)?kernelI(f|13__nv_bfloat16)", name)
        if m and inst:
            dtype = "float32" if inst.group(2) == "f" else "bfloat16"
            kind = "chunk" if inst.group(1) == "chunk_" else "tiles"
            out[f"{kind} {dtype}"] = (int(m.group(1)), *spill)
    return dict(sorted(out.items()))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 19 + [_L] + [_I] * 7 + [_P]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.function("repro_wkv_chunked_bwd", _ARGTYPES)


def wkv_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                    states: torch.Tensor, *, chunk: int,
                    dstate: Optional[torch.Tensor] = None,
                    state: Optional[torch.Tensor] = None, ds0: bool = False):
    """r, k, logw: [BH,T,K]; v, dout: [BH,T,V]; u: [BH,K]; states: the
    forward's float32 [BH, ceil(T / C), K, V] at C = min(chunk, T);
    dstate (None: zero) and, with it, the forward's final ``state``:
    float32 [BH,K,V].  r, k, v and dout share one dtype (float32 or
    bfloat16); logw and u are each float32 or that dtype.  All dense on one
    CUDA device -> (dr, dk, dv, dlogw, du), and dS0 float32 [BH,K,V] with
    ``ds0`` (the forward ran from a given state, which ``states`` holds
    first)."""
    global launches
    if r.dim() != 3 or k.shape != r.shape or logw.shape != r.shape \
            or v.dim() != 3 or v.shape[:2] != r.shape[:2] \
            or dout.shape != v.shape or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError(f"wkv_chunked_bwd: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, dout "
                         f"{tuple(dout.shape)}")
    BH, T, K = r.shape
    V = v.shape[2]
    if min(BH, T, K, V) == 0 or chunk < 1:
        raise ValueError(f"wkv_chunked_bwd: extents BH={BH} T={T} K={K} "
                         f"V={V}, chunk={chunk}; all must be at least 1")
    C = min(chunk, T)
    inst = check_chunk(C, K, V, r.element_size())
    for key, t in (("logw", logw), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"wkv_chunked_bwd: {key} is {t.dtype}; float32 "
                            f"or {r.dtype} (the type of r)")
    f32 = {"states": (states, (BH, _cdiv(T, C), K, V))}
    if dstate is not None:
        f32.update(dstate=(dstate, (BH, K, V)), state=(state, (BH, K, V)))
    for key, (t, shape) in f32.items():
        if t is None or t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"wkv_chunked_bwd: {key} "
                             f"{None if t is None else (tuple(t.shape), t.dtype)}"
                             f", expected float32 {shape}")
    code = check_cuda_dense("wkv_chunked_bwd", r=r, k=k, v=v, dout=dout)
    side = {}
    for key, t in (("logw", logw), ("u", u)):
        side[key] = check_cuda_dense("wkv_chunked_bwd", **{key: t})
    for key, (t, _) in f32.items():
        check_cuda_dense("wkv_chunked_bwd", **{key: t})
    for key, t in (("logw", logw), ("u", u), *((n, t) for n, (t, _) in f32.items())):
        if t.device != r.device:
            raise ValueError(f"wkv_chunked_bwd: {key} on {t.device}, "
                             f"expected {r.device}")
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlogw, du = torch.empty_like(logw), torch.empty_like(u)
    f32kw = dict(dtype=torch.float32, device=r.device)
    gws = torch.empty((BH, _cdiv(T, C), K, V), **f32kw)
    # dlogw without the later chunks' (tiles') totals: in place where it is
    # float32; one partial row of those totals and of du's a chunk (a tile)
    dlw = dlogw if logw.dtype == torch.float32 else torch.empty(
        (BH, T, K), **f32kw)
    n_parts = _cdiv(T, C) * inst["parts"]
    xpart = torch.empty((BH, n_parts, K), **f32kw)
    upart = torch.empty((BH, n_parts, K), **f32kw)
    dS0 = torch.empty((BH, K, V), **f32kw) if ds0 else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(r.device):
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), dout.data_ptr(),
                        ptr(dstate), ptr(state if dstate is not None else None),
                        states.data_ptr(), gws.data_ptr(), dr.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                        du.data_ptr(), dlw.data_ptr(), xpart.data_ptr(),
                        upart.data_ptr(), ptr(dS0), BH, T, K, V, C, code, side["logw"],
                        side["u"], torch.cuda.current_stream().cuda_stream)
    check_launch("wkv_chunked_bwd", err)
    launches += 1
    grads = (dr, dk, dv, dlogw, du)
    return grads if dS0 is None else (*grads, dS0)
