"""Lower a searched schedule onto launch parameters of the Hopper kernels.

The search operates on the zigzag-lite abstract machine; this bridge
maps its decisions onto the port's hand-written CUDA kernels
(``repro_torch/kernels/csrc``) so that the schedule drives real launches:

  fused IBN group    -> kernels.ops.fused_ibn        (block_m, block_f)
  MAC + fused LN     -> kernels.ops.matmul_ln        (block_m, block_k)
  attention matmuls  -> kernels.ops.flash_attention  (block_q, block_k)
  chunked recurrence -> kernels.ops.wkv_chunked      (chunk)

The Hopper launch contract, which every emitted ``block_*`` obeys:

- A block is a value its kernel is compiled for, from a fixed menu:
  ``fused_ibn`` runs (block_m, block_f) = (64, 64) only
  (``FUSED_IBN_BLOCKS``), ``flash_attention`` (block_q, block_k) =
  (64, 64) only (``FLASH_ATTENTION_BLOCKS``), ``matmul_ln`` one template
  instance per block_m in ``MATMUL_LN_BLOCK_M`` = (8, 16, 32, 64), with
  block_k in ``MATMUL_LN_BLOCK_K`` = (16, 32, 64) run on the kernel's one
  32-deep K slab.  The ``ops`` entry points raise on any other value for
  a CUDA tensor.
- ``matmul_ln`` keeps ``block_m`` whole rows of N float32 values in
  shared memory: ``block_m * N * 4 <= MATMUL_LN_SMEM_BYTES`` (160 KiB,
  below sm_90's 227 KiB a block, which also holds the operand tiles).
  The kernel splits N over the blocks of a thread-block cluster, each
  holding its slice of the rows.
  The searched row tile is snapped into the menu and then halved until
  it fits; a layer so wide that 8 rows do not fit is left unlowered.
- A block may be larger than its extent: the kernels take the true
  extents and mask ragged edges themselves, nothing is padded.
  ``ragged[axis] = extent % block`` for every blocked axis (the extent
  itself when the block is larger), as in the JAX package.
- ``rwkv_chunk`` runs at the chunk the kernel is fastest at on this card,
  ``rwkv_chunk.CHUNK`` (``WKV_CHUNK``), cut to T (``lower_scan``), as the
  block menus are snapped; the searched chunk, the paper's accelerator's
  choice, is not the card's.  ``ops.wkv_chunked`` runs it as given: C =
  min(chunk, T) is a run-time argument of the kernel (any C, not only
  powers of two), the last chunk's rows past T are masked by bounds
  (nothing is padded), and ``ragged["t"] = T % chunk``.  The kernel's
  outputs pass holds k and the decay cumsum of a whole chunk in shared
  memory, so C * K may reach 256 * 64 (``rwkv_chunk.smem_bytes`` within
  the 227 KiB of a block); the search's pow2 chunks 8..256 at K <= 64
  all fit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.workload import (MAC_OPS, MATMUL, NORM, PWCONV, SCAN,
                                       SOFTMAX, Layer)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_ibn as _ibn
from repro_torch.kernels import matmul_ln as _mln
from repro_torch.kernels import rwkv_chunk as _wkv
from repro_torch.search import tiler

# the menus are facts of the CUDA builds; the kernel wrappers own them
FUSED_IBN_BLOCKS = _ibn.BLOCKS
FLASH_ATTENTION_BLOCKS = _fa.BLOCKS
MATMUL_LN_BLOCK_M = _mln.BLOCK_M
MATMUL_LN_BLOCK_K = _mln.BLOCK_K
WKV_CHUNK = _wkv.CHUNK
MATMUL_LN_SMEM_BYTES = _mln.SMEM_BYTES


def _snap(v: int, menu: Sequence[int], extent: int) -> Tuple[int, int]:
    """The largest menu block not above ``v`` (the smallest when all
    are), no larger than the smallest menu block that covers the
    extent.  Returns ``(block, n_ragged)`` with
    ``n_ragged = extent % block``."""
    extent = max(1, extent)
    b = max([m for m in menu if m <= v] or [menu[0]])
    cover = [m for m in menu if m >= extent]
    if cover:
        b = min(b, cover[0])
    return b, extent % b


@dataclasses.dataclass(frozen=True)
class LoweredKernel:
    kernel: str     # "fused_ibn" | "matmul_ln" | "flash_attention" | "rwkv_chunk"
    layer_names: Tuple[str, ...]
    params: Dict[str, int]
    # per-axis ragged final-block sizes (0 = the block divides the
    # extent); the kernels mask these edges in-kernel
    ragged: Dict[str, int] = dataclasses.field(default_factory=dict)


def lower_ibn(expand: Layer, project: Layer) -> LoweredKernel:
    """IBN fusion group -> fused_ibn at the one tile the kernel runs; the
    searched tile does not change the launch."""
    n_pix = expand.b * expand.ox * expand.oy
    bm, bf = FUSED_IBN_BLOCKS["block_m"], FUSED_IBN_BLOCKS["block_f"]
    return LoweredKernel("fused_ibn", (expand.name, project.name),
                         dict(FUSED_IBN_BLOCKS),
                         {"m": n_pix % bm, "f": expand.k % bf})


def lower_matmul_ln(mac: Layer, norm: Layer, *, tile_x: int,
                    tile_c: int) -> Optional[LoweredKernel]:
    """MAC layer with a fused trailing LayerNorm -> matmul_ln blocks.
    block_m covers the pixel tile (rows resident for the statistics),
    shrunk until its row buffer fits the shared-memory budget; block_k
    covers the reduction tile.  None when not even the smallest row
    block fits."""
    n_pix = mac.b * mac.ox * mac.oy
    red = mac.c * mac.fx * mac.fy
    bm, _ = _snap(tile_x, MATMUL_LN_BLOCK_M, n_pix)
    while _mln.row_bytes(bm, mac.k) > MATMUL_LN_SMEM_BYTES:
        if bm == MATMUL_LN_BLOCK_M[0]:
            return None
        bm //= 2
    bk, rk = _snap(tile_c, MATMUL_LN_BLOCK_K, red)
    return LoweredKernel("matmul_ln", (mac.name, norm.name),
                         {"block_m": bm, "block_k": bk},
                         {"m": n_pix % bm, "k": rk})


def lower_attention(qk: Layer, *, seq: int) -> LoweredKernel:
    """Attention score/value matmuls -> flash_attention at the one tile
    the kernel runs.  ``seq`` is the softmax extent (the score-row
    length: N for standard attention, the head dim for XCA)."""
    bq, bk = FLASH_ATTENTION_BLOCKS["block_q"], FLASH_ATTENTION_BLOCKS["block_k"]
    return LoweredKernel("flash_attention", (qk.name,),
                         dict(FLASH_ATTENTION_BLOCKS),
                         {"q": seq % bq, "k": seq % bk})


def lower_scan(scan: Layer, tinfo: Dict[str, int]) -> LoweredKernel:
    """Chunked-recurrence layer -> rwkv_chunk(chunk).  The chunk is snapped
    to the card, as the GEMM kernels' blocks are snapped to their menus:
    ``WKV_CHUNK`` (``kernels.rwkv_chunk.CHUNK``, where the kernel is
    fastest in ``profile_wkv``'s chunk sweep on the H100), cut to the
    sequence length.  The searched chunk (``tinfo["chunk"]``) describes
    the paper's accelerator and is not used here.  A non-dividing final
    chunk is reported via ``ragged["t"] = T % chunk``."""
    chunk = max(1, min(WKV_CHUNK, scan.ox))
    ragged = {"t": scan.ox % chunk} if scan.ox % chunk else {}
    return LoweredKernel("rwkv_chunk", (scan.name,),
                         {"chunk": chunk, "bh": scan.b, "t": scan.ox,
                          "k": scan.c, "v": scan.k},
                         ragged)


def lower_schedule(layers: Sequence[Layer], groups, tiles: Dict[str, dict]
                   ) -> List[LoweredKernel]:
    """Emit kernel launch parameters for every lowerable construct in a
    partitioned schedule.

    ``groups`` is the partition's group list (objects with start/end and
    fused_nonlinear); ``tiles`` maps group-head layer names to tile
    summaries (only the pixel and reduction tiles of a matmul_ln group
    are read; missing entries fall back to 64 and 128).
    """
    out: List[LoweredKernel] = []
    groups = list(groups)
    for g in groups:
        sl = layers[g.start:g.end]
        scan = next((l for l in sl if l.op == SCAN), None)
        if scan is not None:
            out.append(lower_scan(scan, tiles.get(scan.name, {})))
            continue
        macs = [l for l in sl if l.op in MAC_OPS]
        # MAC->MAC pixel-aligned pair: score @ softmax @ value chains are
        # the flash-attention kernel; anything else is the fused-IBN one
        sm = next((l for l in sl if l.op == SOFTMAX), None)
        if len(macs) == 2 and tiler.chain_compatible(macs[0], macs[1]):
            if sm is not None:
                out.append(lower_attention(macs[0], seq=sm.c))
            else:
                out.append(lower_ibn(macs[0], macs[1]))
            continue
        if len(macs) == 1:
            mac = macs[0]
            trailing_norm = next(
                (l for l in sl if l.op == NORM and l.name in
                 set(g.fused_nonlinear)), None)
            if mac.op in (PWCONV, MATMUL) and trailing_norm is not None:
                tinfo = tiles.get(mac.name, {})
                lk = lower_matmul_ln(mac, trailing_norm,
                                     tile_x=int(tinfo.get("tile_x") or 64),
                                     tile_c=int(tinfo.get("tile_c") or 128))
                if lk is not None:
                    out.append(lk)
                continue
            if mac.op == MATMUL and sm is not None:
                out.append(lower_attention(mac, seq=sm.c))
                continue
    # decision provenance: kernels emitted by type + groups with no
    # lowerable construct (each group lowers to at most one kernel)
    kinds: Dict[str, int] = {}
    for lk in out:
        kinds[lk.kernel] = kinds.get(lk.kernel, 0) + 1
    for kind, c in kinds.items():
        obs.count(f"lower.kernel.{kind}", c)
    unlowered = len(groups) - len(out)
    if unlowered > 0:
        obs.count("lower.groups_unlowered", unlowered)
    return out


def launch_shape(layers: Sequence[Layer], key: str,
                 entry: Mapping[str, object]) -> Dict[str, int]:
    """The extents a lowered entry launches its kernel at, from the true
    shapes of its layers.  ``key`` is the entry's ``" + "``-joined layer
    names, ``entry`` its ``lowered`` dict (only ``kernel`` is read).

      fused_ibn        m = b*ox*oy, d = c*fx*fy, f = k, do = the
                       projection's k
      matmul_ln        m = b*ox*oy, k = c*fx*fy, n = k
      flash_attention  bh = b, q = ox, k = the softmax extent after the
                       score product, d = c (non-causal)
      rwkv_chunk       bh = b, t = ox, k = c, v = k (the [K, V] state)
    """
    index = {l.name: i for i, l in enumerate(layers)}
    names = key.split(" + ")
    m = layers[index[names[0]]]
    rows = m.b * m.ox * m.oy
    kernel = entry["kernel"]
    if kernel == "fused_ibn":
        return {"m": rows, "d": m.c * m.fx * m.fy, "f": m.k,
                "do": layers[index[names[1]]].k}
    if kernel == "matmul_ln":
        return {"m": rows, "k": m.c * m.fx * m.fy, "n": m.k}
    if kernel == "flash_attention":
        sm = next(l for l in layers[index[m.name] + 1:] if l.op == SOFTMAX)
        return {"bh": m.b, "q": m.ox, "k": sm.c, "d": m.c}
    return {"bh": m.b, "t": m.ox, "k": m.c, "v": m.k}
