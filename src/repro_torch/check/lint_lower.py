"""Lint the Hopper launch parameters a schedule carries in ``lowered``.

Independent re-statement of the launch contract the port's CUDA kernels
assume (``repro_torch.search.lower`` states it), checked against the
``Layer`` shapes alone, without calling ``search.lower`` or importing
the kernel wrappers:

- every block is one its kernel is compiled for: ``fused_ibn``
  (block_m, block_f) = (64, 64) only, ``flash_attention`` (block_q,
  block_k) = (64, 64) only, ``matmul_ln`` block_m in (8, 16, 32, 64) and
  block_k in (16, 32, 64); anything else is ``lint.block_menu``;
- ``matmul_ln`` keeps block_m whole float32 rows of N in shared memory:
  ``block_m * N * 4`` within 160 KiB (``lint.smem``);
- a block may be larger than its extent (the kernels take true extents
  and mask by bounds), and ``ragged[axis] == extent % block`` for every
  blocked axis (``lint.mask_missing`` / ``lint.ragged_stale``);
- ``rwkv_chunk`` runs at ``chunk == min(32, T)`` (``lint.scan_chunk``),
  at the layer's extents (``lint.scan_shape``), with the outputs pass's
  shared memory at that chunk within the 227 KiB a block may have
  (``lint.smem``).

The constants below are copies of the kernel wrappers' own
(``kernels/{fused_ibn,flash_attention,matmul_ln,rwkv_chunk}.py``); a test
holds them equal, so a menu that changes in one place only fails it.  A
block off the menu, a dropped ragged record or a stale remainder all
surface here as findings.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.workload import Layer

from repro_torch.check.schedule import Finding

# the tiles each kernel is compiled for
FUSED_IBN_BLOCKS = {"block_m": 64, "block_f": 64}
FLASH_ATTENTION_BLOCKS = {"block_q": 64, "block_k": 64}
MATMUL_LN_BLOCK_M = (8, 16, 32, 64)
MATMUL_LN_BLOCK_K = (16, 32, 64)
# matmul_ln's float32 row buffer: block_m rows of N, over the whole row
MATMUL_LN_SMEM_BYTES = 160 * 1024
# the chunk the WKV kernel runs at (cut to T), the shared memory a block
# may have, and the outputs pass's layout facts: the V columns a warp
# owns and the rows of a tile
WKV_CHUNK = 32
WKV_SMEM_LIMIT = 227 * 1024
WKV_BVS = 32
WKV_TILE = 16

KERNELS = ("fused_ibn", "matmul_ln", "flash_attention", "rwkv_chunk")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wkv_smem_bytes(chunk: int, k: int) -> int:
    """The least shared memory an outputs-pass block of the WKV kernel
    takes at chunk length ``chunk`` and key width ``k`` (float32 inputs,
    one warp on one tile): k of the chunk and the block's r rows (rows of
    k rounded up to 8, plus 16 bytes), the decay cumsum of the chunk
    (rows of k rounded up to 8, plus 4 columns), the chunk's V tile
    (``WKV_BVS`` columns plus 32 bytes a row), u, the cumsum's partial
    totals, and the warp's q, its block of scores; the chunk rounded up
    to a tile."""
    kp = _cdiv(k, 8) * 8
    ldk, ldkt = kp + 4, kp + 4
    ldvt = WKV_BVS + 8
    cp = _cdiv(chunk, WKV_TILE) * WKV_TILE
    return 4 * (cp * ldkt + (cp + 1) * ldk + WKV_TILE * ldkt
                + WKV_TILE * ldk + cp * ldvt + kp + 32
                + WKV_TILE * (WKV_TILE + 4))


def _check_block(key: str, param: str, block, menu: Sequence[int],
                 findings: List[Finding]) -> Optional[int]:
    """One launch block: an integer its kernel is compiled for.  Returns
    the block when it is a positive integer (on the menu or not), so
    that the ragged records are still checked against it."""
    try:
        b = int(block)
    except (TypeError, ValueError):
        findings.append(Finding("lint.block_type", key,
                                f"{param} = {block!r} is not an int"))
        return None
    if b < 1:
        findings.append(Finding("lint.block_range", key,
                                f"{param} = {b} < 1"))
        return None
    if b not in menu:
        findings.append(Finding(
            "lint.block_menu", key,
            f"{param} = {b} is not one the kernel is compiled for"
            f" {tuple(menu)}"))
    return b


def _check_ragged(key: str, axis: str, block: Optional[int], extent: int,
                  ragged: Dict[str, int],
                  findings: List[Finding]) -> None:
    """Every ragged final block needs its mask record: the ``ragged``
    entry for the axis, holding exactly ``extent % block``."""
    if not block:
        return
    want = max(1, extent) % block
    got = ragged.get(axis)
    if got is None:
        if want:
            findings.append(Finding(
                "lint.mask_missing", key,
                f"axis {axis!r}: block {block} leaves a ragged edge of"
                f" {want} but no mask/ragged record"))
        return
    if int(got) != want:
        findings.append(Finding(
            "lint.ragged_stale", key,
            f"axis {axis!r}: recorded ragged {got} != extent % block"
            f" = {want}"))


def lint_doc(doc: dict,
             layers: Sequence[Layer]) -> List[Finding]:
    """Lint every lowered kernel in an artifact document.  Tolerates
    partial docs (no ``lowered`` -> nothing to lint)."""
    findings: List[Finding] = []
    lowered = doc.get("lowered")
    if not lowered:
        return findings
    by_name = {l.name: l for l in layers}
    groups = doc.get("groups")
    for key, val in lowered.items():
        parts = key.split(" + ")
        missing = [p for p in parts if p not in by_name]
        if missing:
            findings.append(Finding("lint.unknown_layer", key,
                                    f"layers {missing} not in the chain"))
            continue
        group = None
        if groups is not None:
            group = next((g for g in groups if parts[0] in g), None)
            if group is None or any(p not in group for p in parts):
                findings.append(Finding(
                    "lint.cross_group", key,
                    "kernel spans layers from different fusion groups"))
                continue
        kernel = val.get("kernel")
        ragged = dict(val.get("ragged") or {})
        if kernel == "fused_ibn":
            if len(parts) != 2:
                findings.append(Finding("lint.arity", key,
                                        "fused_ibn needs (expand,"
                                        " project)"))
                continue
            expand = by_name[parts[0]]
            m = expand.b * expand.ox * expand.oy
            f = expand.k
            bm = _check_block(key, "block_m", val.get("block_m"),
                              (FUSED_IBN_BLOCKS["block_m"],), findings)
            bf = _check_block(key, "block_f", val.get("block_f"),
                              (FUSED_IBN_BLOCKS["block_f"],), findings)
            _check_ragged(key, "m", bm, m, ragged, findings)
            _check_ragged(key, "f", bf, f, ragged, findings)
        elif kernel == "matmul_ln":
            if len(parts) != 2:
                findings.append(Finding("lint.arity", key,
                                        "matmul_ln needs (mac, norm)"))
                continue
            mac = by_name[parts[0]]
            m = mac.b * mac.ox * mac.oy
            red = mac.c * mac.fx * mac.fy
            bm = _check_block(key, "block_m", val.get("block_m"),
                              MATMUL_LN_BLOCK_M, findings)
            bk = _check_block(key, "block_k", val.get("block_k"),
                              MATMUL_LN_BLOCK_K, findings)
            if bm and bm * mac.k * 4 > MATMUL_LN_SMEM_BYTES:
                findings.append(Finding(
                    "lint.smem", key,
                    f"a row buffer of block_m = {bm} rows of N ="
                    f" {mac.k} float32 is {bm * mac.k * 4} bytes, over"
                    f" the {MATMUL_LN_SMEM_BYTES}-byte budget"))
            _check_ragged(key, "m", bm, m, ragged, findings)
            _check_ragged(key, "k", bk, red, ragged, findings)
        elif kernel == "flash_attention":
            qk = by_name[parts[0]]
            seq = qk.c
            if group is not None:
                sm = next((by_name[n] for n in group
                           if by_name[n].op == "softmax"), None)
                if sm is not None:
                    seq = sm.c
            bq = _check_block(key, "block_q", val.get("block_q"),
                              (FLASH_ATTENTION_BLOCKS["block_q"],),
                              findings)
            bk = _check_block(key, "block_k", val.get("block_k"),
                              (FLASH_ATTENTION_BLOCKS["block_k"],),
                              findings)
            _check_ragged(key, "q", bq, seq, ragged, findings)
            _check_ragged(key, "k", bk, seq, ragged, findings)
        elif kernel == "rwkv_chunk":
            scan = by_name[parts[0]]
            for param, want in (("bh", scan.b), ("t", scan.ox),
                                ("k", scan.c), ("v", scan.k)):
                if int(val.get(param, want)) != want:
                    findings.append(Finding(
                        "lint.scan_shape", key,
                        f"{param} = {val.get(param)} != layer"
                        f" extent {want}"))
            chunk = int(val.get("chunk", 0))
            want = max(1, min(WKV_CHUNK, scan.ox))
            if chunk < 1:
                findings.append(Finding(
                    "lint.scan_chunk", key, f"chunk {chunk} < 1"))
                continue
            if chunk != want:
                findings.append(Finding(
                    "lint.scan_chunk", key,
                    f"chunk {chunk} != min({WKV_CHUNK}, t={scan.ox})"
                    f" = {want}"))
            smem = wkv_smem_bytes(min(chunk, max(1, scan.ox)), scan.c)
            if smem > WKV_SMEM_LIMIT:
                findings.append(Finding(
                    "lint.smem", key,
                    f"the outputs pass at chunk {chunk}, k = {scan.c}"
                    f" needs {smem} bytes of shared memory, over"
                    f" {WKV_SMEM_LIMIT}"))
            # the scan tail is the kernel's only ragged edge; the
            # carry makes a dropped tail mask a silent wrong answer
            _check_ragged(key, "t", chunk, scan.ox, ragged, findings)
        else:
            findings.append(Finding("lint.unknown_kernel", key,
                                    f"kernel {kernel!r} not one of"
                                    f" {KERNELS}"))
    return findings
