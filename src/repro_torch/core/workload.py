"""Workload descriptions: every layer as a set of nested-loop dims.

This is the representation ZigZag [25] (and our zigzag-lite cost model)
operates on — Fig 1 of the paper.  Loop dims follow ZigZag naming:

  B  batch          K  output channels    C  input channels
  OX/OY output spatial                    FX/FY kernel spatial

A matmul [M,Kc] @ [Kc,N] maps to OX=M, C=Kc, K=N (GEMM as 1x1 conv).
``edgenext_workload`` walks the exact EdgeNeXt-S graph (same structure as
models/edgenext.py) and emits the layer list the benchmarks cost out.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import List, Optional, Tuple

from repro_torch.configs.edgenext_s import EdgeNeXtConfig

# op taxonomy
CONV = "conv"          # dense conv (stem / downsample)
DWCONV = "dwconv"      # depthwise conv
PWCONV = "pwconv"      # pointwise (1x1) conv / linear
MATMUL = "matmul"      # attention matmuls
NORM = "norm"          # LayerNorm (channel-dim statistics)
SOFTMAX = "softmax"
ACT = "act"            # GELU etc.
ELEMWISE = "elemwise"  # residual add / scale
SCAN = "scan"          # chunked recurrence (WKV / RG-LRU state scan)

MAC_OPS = (CONV, DWCONV, PWCONV, MATMUL)

# SCAN is deliberately NOT in MAC_OPS: it is compute-bearing but its
# sequence dim (ox) carries a sequential state dependency, so every
# MAC-generic code path (spatial split of any dim, free temporal
# reordering, MAC-chain tiling) would be illegal for it.  Dim roles:
#   b  = batch x heads     ox = sequence length T (the carry dim)
#   c  = state key dim K   k  = state value dim V      oy=fx=fy=1
# The [K, V] running state carries across chunks of ``ox``; the chunk
# length is a schedule decision (see search.auto), not a layer dim.


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    op: str
    b: int = 1
    k: int = 1      # output channels (1 for dwconv groups)
    c: int = 1      # input channels (per group for dwconv)
    ox: int = 1
    oy: int = 1
    fx: int = 1
    fy: int = 1
    bits: int = 8
    # graph role annotations used by the fusion planner
    ibn_role: Optional[str] = None   # "expand" | "act" | "project"
    ibn_id: int = -1                 # groups the three IBN layers

    @property
    def signature(self) -> str:
        """Canonical content signature: a hash of the layer's op type and
        loop-dim extents only — independent of its name, chain position,
        and graph-role annotations (``ibn_role``/``ibn_id``), none of
        which the search consults.  Two layers with equal signatures are
        interchangeable to every scheduler decision, which is what the
        unique-layer memo (``search.memo``) and the schedule cache key
        (``search.cache.schedule_key``) rely on."""
        return _layer_signature(self.op, self.b, self.k, self.c, self.ox,
                                self.oy, self.fx, self.fy, self.bits)

    @property
    def macs(self) -> int:
        if self.op == SCAN:
            # chunk-independent floor: per token, one [K]x[K,V] state
            # read-out plus one [K]x[V] outer-product state update.
            # The intra-chunk [C, C] score matrix depends on the
            # searched chunk length — see ``scan_macs``.
            return 2 * self.b * self.ox * self.c * self.k
        if self.op not in MAC_OPS:
            return 0
        return (self.b * self.k * self.c * self.ox * self.oy
                * self.fx * self.fy)

    @property
    def input_elems(self) -> int:
        if self.op == SCAN:
            # r, k, decay each [T, K] plus v [T, V], per b instance
            return self.b * self.ox * (3 * self.c + self.k)
        if self.op == DWCONV:
            return self.b * self.c * (self.ox + self.fx - 1) * \
                (self.oy + self.fy - 1)
        if self.op in (CONV, PWCONV, MATMUL):
            return self.b * self.c * self.ox * self.oy * \
                (self.fx * self.fy if self.op == CONV else 1)
        return self.b * self.c * self.ox * self.oy

    @property
    def output_elems(self) -> int:
        if self.op == SCAN:
            return self.b * self.ox * self.k
        if self.op not in MAC_OPS:          # norm/act/elemwise: same shape
            return self.input_elems
        k = self.k if self.op != DWCONV else self.c
        return self.b * k * self.ox * self.oy

    @property
    def weight_elems(self) -> int:
        if self.op == DWCONV:
            return self.c * self.fx * self.fy
        if self.op in (CONV, PWCONV, MATMUL):
            return self.k * self.c * self.fx * self.fy
        if self.op == SCAN:
            return self.b * self.c        # per-head bonus vector u [K]
        return 0

    @property
    def input_bytes(self) -> int:
        return self.input_elems * self.bits // 8

    @property
    def output_bytes(self) -> int:
        return self.output_elems * self.bits // 8

    @property
    def weight_bytes(self) -> int:
        return self.weight_elems * self.bits // 8


@functools.lru_cache(maxsize=None)
def _layer_signature(op: str, b: int, k: int, c: int, ox: int, oy: int,
                     fx: int, fy: int, bits: int) -> str:
    blob = f"{op}:{b}:{k}:{c}:{ox}:{oy}:{fx}:{fy}:{bits}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# EdgeNeXt-S workload
# ---------------------------------------------------------------------------


def _split_widths(c: int, scales: int) -> List[int]:
    import math
    if scales == 1:
        return [c]
    base = int(math.ceil(c / scales))
    w = [base] * (scales - 1)
    w.append(c - base * (scales - 1))
    return w


def edgenext_workload(cfg: EdgeNeXtConfig, batch: int = 1) -> List[Layer]:
    """The full EdgeNeXt-S layer list at ``cfg.img_size`` input."""
    layers: List[Layer] = []
    ibn_counter = [0]

    def ibn(prefix: str, n: int, c: int, expan: int):
        """pw-expand -> act -> pw-project (the inverted bottleneck)."""
        i = ibn_counter[0]
        ibn_counter[0] += 1
        layers.append(Layer(f"{prefix}.pw1", PWCONV, b=batch, k=expan * c,
                            c=c, ox=n, ibn_role="expand", ibn_id=i))
        layers.append(Layer(f"{prefix}.act", ACT, b=batch, c=expan * c, ox=n,
                            ibn_role="act", ibn_id=i))
        layers.append(Layer(f"{prefix}.pw2", PWCONV, b=batch, k=c,
                            c=expan * c, ox=n, ibn_role="project", ibn_id=i))

    res = cfg.img_size
    for si in range(4):
        c = cfg.dims[si]
        if si == 0:
            res //= 4
            layers.append(Layer("stem", CONV, b=batch, k=c,
                                c=cfg.in_channels, ox=res, oy=res, fx=4,
                                fy=4))
        else:
            cp = cfg.dims[si - 1]
            layers.append(Layer(f"s{si}.down_ln", NORM, b=batch, c=cp,
                                ox=res, oy=res))
            res //= 2
            layers.append(Layer(f"s{si}.down", CONV, b=batch, k=c, c=cp,
                                ox=res, oy=res, fx=2, fy=2))
        n_conv = cfg.depths[si] - cfg.sdta_blocks[si]
        ks = cfg.kernel_sizes[si]
        for bi in range(n_conv):
            p = f"s{si}.conv{bi}"
            layers.append(Layer(f"{p}.dw", DWCONV, b=batch, c=c, ox=res,
                                oy=res, fx=ks, fy=ks))
            layers.append(Layer(f"{p}.ln", NORM, b=batch, c=c, ox=res,
                                oy=res))
            ibn(p, res * res, c, cfg.expan_ratio)
            layers.append(Layer(f"{p}.res", ELEMWISE, b=batch, c=c, ox=res,
                                oy=res))
        for bi in range(cfg.sdta_blocks[si]):
            p = f"s{si}.sdta{bi}"
            widths = _split_widths(c, cfg.sdta_scales[si])
            for wi, w in enumerate(widths[1:]):
                layers.append(Layer(f"{p}.dw{wi}", DWCONV, b=batch, c=w,
                                    ox=res, oy=res, fx=3, fy=3))
            n = res * res
            dh = c // cfg.heads
            layers.append(Layer(f"{p}.ln_x", NORM, b=batch, c=c, ox=n))
            layers.append(Layer(f"{p}.qkv", PWCONV, b=batch, k=3 * c, c=c,
                                ox=n))
            # XCA: scores [C/h, C/h] = q [C/h, N] @ k^T [N, C/h] per head
            layers.append(Layer(f"{p}.qk", MATMUL, b=batch * cfg.heads,
                                k=dh, c=n, ox=dh))
            layers.append(Layer(f"{p}.sm", SOFTMAX, b=batch * cfg.heads,
                                c=dh, ox=dh))
            layers.append(Layer(f"{p}.av", MATMUL, b=batch * cfg.heads,
                                k=n, c=dh, ox=dh))
            layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=c, c=c,
                                ox=n))
            layers.append(Layer(f"{p}.ln_m", NORM, b=batch, c=c, ox=n))
            ibn(p, n, c, cfg.expan_ratio)
            layers.append(Layer(f"{p}.res", ELEMWISE, b=batch, c=c, ox=n))
    layers.append(Layer("head.ln", NORM, b=batch, c=cfg.dims[-1]))
    layers.append(Layer("head.fc", PWCONV, b=batch, k=cfg.num_classes,
                        c=cfg.dims[-1]))
    return layers


def with_batch(layers: List[Layer], batch: int) -> List[Layer]:
    """Re-shape a layer chain to a serving batch: every layer's batch
    loop-dim scales by ``batch`` (attention layers already folding
    heads / patches into ``b`` scale the same way, which is exactly how
    the ``*_workload(batch=...)`` builders construct their batched
    chains — ``with_batch(wl(batch=1), b) == wl(batch=b)`` layer for
    layer, names included).  Batch is thereby a first-class mapspace
    dim: the transformed chain has new content signatures, so the
    schedule cache / serve store co-search and key each batch level
    independently."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if batch == 1:
        return list(layers)
    return [dataclasses.replace(l, b=l.b * batch) for l in layers]


def edgenext_serving_workload(batch: int = 4,
                              cfg: Optional[EdgeNeXtConfig] = None
                              ) -> List[Layer]:
    """EdgeNeXt-S at a batch>1 serving shape.

    Batching multiplies every pixel extent (``b * ox * oy``) by
    ``batch`` while the channel extents keep the odd stage dims
    (48/96/160/304) — the regime where power-of-two tiles go ragged and
    the divisor/imperfect-factor tiler has to charge the ragged slabs
    their true cost.  Used by the DSE as the serving-throughput design
    point next to the paper's batch-1 latency point.
    """
    from repro_torch.configs.edgenext_s import CONFIG
    return edgenext_workload(cfg or CONFIG, batch=batch)


# ---------------------------------------------------------------------------
# SCAN (chunked recurrence) helpers
# ---------------------------------------------------------------------------


def scan_macs(layer: Layer, chunk: int) -> int:
    """Total MACs of a SCAN layer executed at chunk length ``chunk``.

    Per chunk of C tokens (the intra/inter split of
    ``kernels/rwkv_chunk.wkv_chunked``):
      inter  = r_dec [C,K] @ state [K,V]        -> C*K*V
      score  = r [C,K] @ k_dec^T [K,C]          -> C*C*K   (the [C,C] matrix)
      intra  = A [C,C] @ v [C,V]                -> C*C*V
      update = k_dec^T [K,C] @ v [C,V]          -> K*C*V
    Summed over T/C chunks the inter+update terms are chunk-independent
    (= ``Layer.macs``); the score+intra terms grow linearly with C.
    """
    l = layer
    return l.b * (2 * l.ox * l.c * l.k + l.ox * chunk * (l.c + l.k))


def scan_state_bytes(layer: Layer) -> int:
    """Bytes of the fp32 [K, V] running state one scan instance carries
    across chunk boundaries — the residency operand the hierarchy must
    hold for the whole sequence sweep."""
    return 4 * layer.c * layer.k


# ---------------------------------------------------------------------------
# Additional workloads (auto-scheduler generalization targets)
# ---------------------------------------------------------------------------


def vit_workload(*, img_size: int = 224, patch: int = 16, dim: int = 192,
                 depth: int = 12, heads: int = 3, mlp_ratio: int = 4,
                 num_classes: int = 1000, batch: int = 1) -> List[Layer]:
    """A plain ViT (defaults: ViT-Tiny/16) as a loop-dim layer chain.

    Standard softmax attention (scores are [N, N] per head — token-dim
    reduction, unlike XCA's channel-dim) followed by the MLP inverted
    bottleneck.  Exercises the scheduler on a workload with no
    convolutions after the patch embedding.
    """
    layers: List[Layer] = []
    n = (img_size // patch) ** 2
    dh = dim // heads
    layers.append(Layer("patch_embed", CONV, b=batch, k=dim, c=3,
                        ox=img_size // patch, oy=img_size // patch,
                        fx=patch, fy=patch))
    for bi in range(depth):
        p = f"blk{bi}"
        layers.append(Layer(f"{p}.ln1", NORM, b=batch, c=dim, ox=n))
        layers.append(Layer(f"{p}.qkv", PWCONV, b=batch, k=3 * dim, c=dim,
                            ox=n))
        # scores [N, N] = q [N, dh] @ k^T [dh, N] per head
        layers.append(Layer(f"{p}.qk", MATMUL, b=batch * heads, k=n, c=dh,
                            ox=n))
        layers.append(Layer(f"{p}.sm", SOFTMAX, b=batch * heads, c=n, ox=n))
        # out [N, dh] = probs [N, N] @ v [N, dh]
        layers.append(Layer(f"{p}.av", MATMUL, b=batch * heads, k=dh, c=n,
                            ox=n))
        layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=dim, c=dim,
                            ox=n))
        layers.append(Layer(f"{p}.res1", ELEMWISE, b=batch, c=dim, ox=n))
        layers.append(Layer(f"{p}.ln2", NORM, b=batch, c=dim, ox=n))
        layers.append(Layer(f"{p}.fc1", PWCONV, b=batch, k=mlp_ratio * dim,
                            c=dim, ox=n, ibn_role="expand", ibn_id=1000 + bi))
        layers.append(Layer(f"{p}.act", ACT, b=batch, c=mlp_ratio * dim,
                            ox=n, ibn_role="act", ibn_id=1000 + bi))
        layers.append(Layer(f"{p}.fc2", PWCONV, b=batch, k=dim,
                            c=mlp_ratio * dim, ox=n, ibn_role="project",
                            ibn_id=1000 + bi))
        layers.append(Layer(f"{p}.res2", ELEMWISE, b=batch, c=dim, ox=n))
    layers.append(Layer("head.ln", NORM, b=batch, c=dim))
    layers.append(Layer("head.fc", PWCONV, b=batch, k=num_classes, c=dim))
    return layers


def efficientvit_workload(*, img_size: int = 224,
                          widths: Tuple[int, ...] = (16, 32, 64, 128),
                          depths: Tuple[int, ...] = (1, 2, 2, 2),
                          attn_stages: Tuple[int, ...] = (2, 3),
                          heads: int = 4, expand: int = 4,
                          num_classes: int = 1000,
                          batch: int = 1) -> List[Layer]:
    """An EfficientViT-style hybrid (arXiv 2403.20230's target family):
    MBConv stages (depthwise + pointwise inverted bottlenecks) with
    ReLU-linear-attention blocks in the late stages.  Linear attention
    contracts [dh, dh] = k^T v first, so its matmuls are tiny-output /
    long-reduction — a mapping regime the EdgeNeXt trio never sees.
    """
    layers: List[Layer] = []
    res = img_size // 2
    layers.append(Layer("stem", CONV, b=batch, k=widths[0], c=3, ox=res,
                        oy=res, fx=3, fy=3))
    ibn_id = [2000]
    for si, (w, d) in enumerate(zip(widths, depths)):
        if si > 0:
            res //= 2
            layers.append(Layer(f"s{si}.down", CONV, b=batch, k=w,
                                c=widths[si - 1], ox=res, oy=res, fx=2,
                                fy=2))
        n = res * res
        for bi in range(d):
            p = f"s{si}.mb{bi}"
            i = ibn_id[0]
            ibn_id[0] += 1
            layers.append(Layer(f"{p}.dw", DWCONV, b=batch, c=w, ox=res,
                                oy=res, fx=3, fy=3))
            layers.append(Layer(f"{p}.ln", NORM, b=batch, c=w, ox=res,
                                oy=res))
            layers.append(Layer(f"{p}.pw1", PWCONV, b=batch, k=expand * w,
                                c=w, ox=n, ibn_role="expand", ibn_id=i))
            layers.append(Layer(f"{p}.act", ACT, b=batch, c=expand * w,
                                ox=n, ibn_role="act", ibn_id=i))
            layers.append(Layer(f"{p}.pw2", PWCONV, b=batch, k=w,
                                c=expand * w, ox=n, ibn_role="project",
                                ibn_id=i))
            layers.append(Layer(f"{p}.res", ELEMWISE, b=batch, c=w, ox=res,
                                oy=res))
        if si in attn_stages:
            p = f"s{si}.attn"
            dh = max(1, w // heads)
            layers.append(Layer(f"{p}.qkv", PWCONV, b=batch, k=3 * w, c=w,
                                ox=n))
            # linear attention: kv [dh, dh] = k^T [dh, N] @ v [N, dh]
            layers.append(Layer(f"{p}.kv", MATMUL, b=batch * heads, k=dh,
                                c=n, ox=dh))
            # q @ kv: [N, dh]
            layers.append(Layer(f"{p}.qkv_mul", MATMUL, b=batch * heads,
                                k=dh, c=dh, ox=n))
            layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=w, c=w,
                                ox=n))
            layers.append(Layer(f"{p}.res", ELEMWISE, b=batch, c=w, ox=n))
    layers.append(Layer("head.ln", NORM, b=batch, c=widths[-1]))
    layers.append(Layer("head.fc", PWCONV, b=batch, k=num_classes,
                        c=widths[-1]))
    return layers


def mobilevit_workload(*, img_size: int = 256,
                       mv2_out: Tuple[int, ...] = (32, 64, 96, 128, 160),
                       vit_dims: Tuple[int, ...] = (144, 192, 240),
                       vit_depths: Tuple[int, ...] = (2, 4, 3),
                       heads: int = 4, ffn_ratio: int = 2,
                       mv2_expand: int = 4, patch: int = 2,
                       num_classes: int = 1000,
                       batch: int = 1) -> List[Layer]:
    """MobileViT-S [arXiv:2110.02178] as a loop-dim layer chain — the
    second hybrid-ViT graph next to EdgeNeXt-S (defaults follow the S
    variant: ~5.6M params / ~2 GMACs at 256x256).

    MV2 stages are MobileNetV2 inverted residuals (pw-expand -> act ->
    dw 3x3 -> pw-project): unlike EdgeNeXt's IBNs the depthwise sits
    *inside* the bottleneck, so no (expand, act, project) ibn triple is
    annotated — the DP partitioner has to discover what is fusible from
    traffic alone.  MobileViT blocks unfold the feature map into
    ``patch*patch`` pixel streams of N = H*W/patch^2 tokens and run a
    standard softmax transformer on each (token-dim attention — the
    regime XCA never exercises), with a 2x FFN carrying real ibn roles.
    """
    layers: List[Layer] = []
    ibn_id = [3000]

    def mv2(prefix: str, res: int, c_in: int, c_out: int, stride: int):
        ce = mv2_expand * c_in
        r_out = res // stride
        layers.append(Layer(f"{prefix}.pw1", PWCONV, b=batch, k=ce,
                            c=c_in, ox=res * res))
        layers.append(Layer(f"{prefix}.act", ACT, b=batch, c=ce,
                            ox=res * res))
        layers.append(Layer(f"{prefix}.dw", DWCONV, b=batch, c=ce,
                            ox=r_out, oy=r_out, fx=3, fy=3))
        layers.append(Layer(f"{prefix}.pw2", PWCONV, b=batch, k=c_out,
                            c=ce, ox=r_out * r_out))
        if stride == 1 and c_in == c_out:
            layers.append(Layer(f"{prefix}.res", ELEMWISE, b=batch,
                                c=c_out, ox=r_out * r_out))
        return r_out

    def mvit(prefix: str, res: int, c: int, d: int, depth: int):
        n_pix = res * res
        n_tok = n_pix // (patch * patch)
        dh = max(1, d // heads)
        b_attn = batch * patch * patch * heads
        layers.append(Layer(f"{prefix}.conv3", CONV, b=batch, k=c, c=c,
                            ox=res, oy=res, fx=3, fy=3))
        layers.append(Layer(f"{prefix}.conv1", PWCONV, b=batch, k=d, c=c,
                            ox=n_pix))
        for bi in range(depth):
            p = f"{prefix}.t{bi}"
            i = ibn_id[0]
            ibn_id[0] += 1
            layers.append(Layer(f"{p}.ln1", NORM, b=batch, c=d, ox=n_pix))
            layers.append(Layer(f"{p}.qkv", PWCONV, b=batch, k=3 * d, c=d,
                                ox=n_pix))
            # scores [N, N] = q [N, dh] @ k^T [dh, N] per head and patch
            layers.append(Layer(f"{p}.qk", MATMUL, b=b_attn, k=n_tok,
                                c=dh, ox=n_tok))
            layers.append(Layer(f"{p}.sm", SOFTMAX, b=b_attn, c=n_tok,
                                ox=n_tok))
            layers.append(Layer(f"{p}.av", MATMUL, b=b_attn, k=dh,
                                c=n_tok, ox=n_tok))
            layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=d, c=d,
                                ox=n_pix))
            layers.append(Layer(f"{p}.res1", ELEMWISE, b=batch, c=d,
                                ox=n_pix))
            layers.append(Layer(f"{p}.ln2", NORM, b=batch, c=d, ox=n_pix))
            layers.append(Layer(f"{p}.fc1", PWCONV, b=batch,
                                k=ffn_ratio * d, c=d, ox=n_pix,
                                ibn_role="expand", ibn_id=i))
            layers.append(Layer(f"{p}.act", ACT, b=batch,
                                c=ffn_ratio * d, ox=n_pix,
                                ibn_role="act", ibn_id=i))
            layers.append(Layer(f"{p}.fc2", PWCONV, b=batch, k=d,
                                c=ffn_ratio * d, ox=n_pix,
                                ibn_role="project", ibn_id=i))
            layers.append(Layer(f"{p}.res2", ELEMWISE, b=batch, c=d,
                                ox=n_pix))
        layers.append(Layer(f"{prefix}.ln", NORM, b=batch, c=d, ox=n_pix))
        layers.append(Layer(f"{prefix}.fold", PWCONV, b=batch, k=c, c=d,
                            ox=n_pix))
        # concat(input, folded) -> 3x3 fusion conv back to c channels
        layers.append(Layer(f"{prefix}.fuse", CONV, b=batch, k=c,
                            c=2 * c, ox=res, oy=res, fx=3, fy=3))

    res = img_size // 2
    layers.append(Layer("stem", CONV, b=batch, k=16, c=3, ox=res, oy=res,
                        fx=3, fy=3))
    res = mv2("s0.mv0", res, 16, mv2_out[0], 1)
    res = mv2("s1.mv0", res, mv2_out[0], mv2_out[1], 2)
    res = mv2("s1.mv1", res, mv2_out[1], mv2_out[1], 1)
    res = mv2("s1.mv2", res, mv2_out[1], mv2_out[1], 1)
    for si, (c, d, depth) in enumerate(zip(mv2_out[2:], vit_dims,
                                           vit_depths)):
        c_prev = mv2_out[2 + si - 1] if si else mv2_out[1]
        res = mv2(f"s{2 + si}.mv0", res, c_prev, c, 2)
        mvit(f"s{2 + si}.vit", res, c, d, depth)
    layers.append(Layer("head.conv", PWCONV, b=batch, k=4 * mv2_out[-1],
                        c=mv2_out[-1], ox=res * res))
    layers.append(Layer("head.fc", PWCONV, b=batch,
                        k=num_classes, c=4 * mv2_out[-1]))
    return layers


def fastvit_workload(*, img_size: int = 256,
                     dims: Tuple[int, ...] = (64, 128, 256, 512),
                     depths: Tuple[int, ...] = (2, 2, 6, 2),
                     attn_stages: Tuple[int, ...] = (3,),
                     heads: int = 8, mlp_ratio: int = 3,
                     num_classes: int = 1000,
                     batch: int = 1) -> List[Layer]:
    """A FastViT-style hybrid [arXiv:2303.14189, SA12-like defaults] as
    a loop-dim layer chain — the third repeat-heavy hybrid-ViT graph
    next to EdgeNeXt-S and MobileViT-S.

    RepMixer stages: each block is a depthwise 3x3 token mixer followed
    by a ConvFFN (depthwise 7x7 + pw-expand -> act -> pw-project, the
    pw pair annotated as an IBN triple).  The last stage swaps the
    token mixer for softmax self-attention over the stage's native
    token grid (res/32 of the input, so 8x8 = 64 tokens at the 256
    default).  Patch embeddings between stages are dw 7x7 stride-2 +
    pw (the train-time RepMixer/MobileOne overparameterization folds
    into single convs at inference, which is what this chain models).
    Stage depths repeat *identical* block shapes — the regime the
    unique-layer memo fans out over.
    """
    layers: List[Layer] = []
    ibn_id = [4000]
    res = img_size // 4
    # folded MobileOne stem: two stride-2 3x3 convs + a pointwise
    layers.append(Layer("stem.c0", CONV, b=batch, k=dims[0] // 2, c=3,
                        ox=img_size // 2, oy=img_size // 2, fx=3, fy=3))
    layers.append(Layer("stem.c1", DWCONV, b=batch, c=dims[0] // 2,
                        ox=res, oy=res, fx=3, fy=3))
    layers.append(Layer("stem.c2", PWCONV, b=batch, k=dims[0],
                        c=dims[0] // 2, ox=res * res))

    def conv_ffn(prefix: str, n: int, c: int, res_xy: int):
        i = ibn_id[0]
        ibn_id[0] += 1
        layers.append(Layer(f"{prefix}.ffn_dw", DWCONV, b=batch, c=c,
                            ox=res_xy, oy=res_xy, fx=7, fy=7))
        layers.append(Layer(f"{prefix}.fc1", PWCONV, b=batch,
                            k=mlp_ratio * c, c=c, ox=n,
                            ibn_role="expand", ibn_id=i))
        layers.append(Layer(f"{prefix}.act", ACT, b=batch,
                            c=mlp_ratio * c, ox=n,
                            ibn_role="act", ibn_id=i))
        layers.append(Layer(f"{prefix}.fc2", PWCONV, b=batch, k=c,
                            c=mlp_ratio * c, ox=n,
                            ibn_role="project", ibn_id=i))
        layers.append(Layer(f"{prefix}.res", ELEMWISE, b=batch, c=c,
                            ox=n))

    for si, (c, d) in enumerate(zip(dims, depths)):
        if si > 0:
            # patch embed: dw 7x7 stride 2 + pw channel mix
            layers.append(Layer(f"s{si}.embed_dw", DWCONV, b=batch,
                                c=dims[si - 1], ox=res // 2, oy=res // 2,
                                fx=7, fy=7))
            res //= 2
            layers.append(Layer(f"s{si}.embed_pw", PWCONV, b=batch, k=c,
                                c=dims[si - 1], ox=res * res))
        n = res * res
        dh = max(1, c // heads)
        for bi in range(d):
            p = f"s{si}.blk{bi}"
            if si in attn_stages:
                layers.append(Layer(f"{p}.ln", NORM, b=batch, c=c, ox=n))
                layers.append(Layer(f"{p}.qkv", PWCONV, b=batch,
                                    k=3 * c, c=c, ox=n))
                layers.append(Layer(f"{p}.qk", MATMUL,
                                    b=batch * heads, k=n, c=dh, ox=n))
                layers.append(Layer(f"{p}.sm", SOFTMAX,
                                    b=batch * heads, c=n, ox=n))
                layers.append(Layer(f"{p}.av", MATMUL,
                                    b=batch * heads, k=dh, c=n, ox=n))
                layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=c,
                                    c=c, ox=n))
                layers.append(Layer(f"{p}.res_a", ELEMWISE, b=batch,
                                    c=c, ox=n))
            else:
                # RepMixer token mixer (folded to one dw 3x3 + residual)
                layers.append(Layer(f"{p}.mix_dw", DWCONV, b=batch, c=c,
                                    ox=res, oy=res, fx=3, fy=3))
                layers.append(Layer(f"{p}.res_m", ELEMWISE, b=batch,
                                    c=c, ox=n))
            conv_ffn(p, n, c, res)
    layers.append(Layer("head.ln", NORM, b=batch, c=dims[-1]))
    layers.append(Layer("head.fc", PWCONV, b=batch, k=num_classes,
                        c=dims[-1]))
    return layers


def fastvit_serving_workload(batch: int = 4) -> List[Layer]:
    """FastViT-style graph at a batch>1 serving shape — the third
    repeat-heavy serving point for the DSE next to the EdgeNeXt-S and
    MobileViT-S b4 shapes."""
    return fastvit_workload(batch=batch)


def mobilevit_serving_workload(batch: int = 4) -> List[Layer]:
    """MobileViT-S at a batch>1 serving shape (pixel extents scale by
    the batch while the odd channel/dim extents — 96/144/160/240 — keep
    the imperfect-factor tiler honest), the second DSE serving point
    next to ``edgenext_serving_workload``."""
    return mobilevit_workload(batch=batch)


# ---------------------------------------------------------------------------
# Chunked-recurrence workloads (SCAN op class)
# ---------------------------------------------------------------------------


def rwkv6_workload(*, seq: int = 512, n_layers: int = 24, dim: int = 2048,
                   heads: int = 32, head_dim: int = 64, ff: int = 7168,
                   batch: int = 1) -> List[Layer]:
    """RWKV6-1.6B-style blocks (configs/rwkv6_1_6b.py dims) at a prefill
    sequence length.

    Each block: time-mix (fused r/k/v/g projections, the WKV chunked
    scan over ``heads`` independent [K, V] states, group-norm, output
    projection) then channel-mix as a squared-ReLU inverted bottleneck.
    The decay LoRA (d -> 64 -> d) is folded into the projection GEMM;
    the LM head is omitted — it is one dense GEMM the vision registry
    already covers, and it would drown the scan layers in the EDP.
    """
    layers: List[Layer] = []
    t = seq
    for bi in range(n_layers):
        p = f"blk{bi}"
        layers.append(Layer(f"{p}.ln1", NORM, b=batch, c=dim, ox=t))
        layers.append(Layer(f"{p}.tmix.rkvg", PWCONV, b=batch, k=4 * dim,
                            c=dim, ox=t))
        layers.append(Layer(f"{p}.tmix.wkv", SCAN, b=batch * heads, ox=t,
                            c=head_dim, k=head_dim))
        layers.append(Layer(f"{p}.tmix.gn", NORM, b=batch, c=dim, ox=t))
        layers.append(Layer(f"{p}.tmix.out", PWCONV, b=batch, k=dim, c=dim,
                            ox=t))
        layers.append(Layer(f"{p}.res1", ELEMWISE, b=batch, c=dim, ox=t))
        layers.append(Layer(f"{p}.ln2", NORM, b=batch, c=dim, ox=t))
        layers.append(Layer(f"{p}.cmix.key", PWCONV, b=batch, k=ff, c=dim,
                            ox=t, ibn_role="expand", ibn_id=3000 + bi))
        layers.append(Layer(f"{p}.cmix.act", ACT, b=batch, c=ff, ox=t,
                            ibn_role="act", ibn_id=3000 + bi))
        layers.append(Layer(f"{p}.cmix.value", PWCONV, b=batch, k=dim,
                            c=ff, ox=t, ibn_role="project",
                            ibn_id=3000 + bi))
        layers.append(Layer(f"{p}.res2", ELEMWISE, b=batch, c=dim, ox=t))
    layers.append(Layer("head.ln", NORM, b=batch, c=dim, ox=t))
    return layers


def recurrentgemma_workload(*, seq: int = 448, n_layers: int = 26,
                            dim: int = 2560, heads: int = 10,
                            head_dim: int = 256, ff: int = 7680,
                            lru_width: int = 2560, conv1d_width: int = 4,
                            batch: int = 1) -> List[Layer]:
    """RecurrentGemma-2B-style blocks (configs/recurrentgemma_2b.py dims)
    with the (recurrent, recurrent, attention) pattern.

    Recurrent blocks: GeGLU-style dual linear branch, causal width-4
    conv1d over the sequence (a 1-D DWCONV), block-diagonal gate GEMMs,
    and the RG-LRU as a degenerate SCAN with a [1, lru_width] state —
    elementwise diagonal recurrence, so the intra-chunk score matrix is
    pure chunking overhead and the search should pick a small chunk.
    Attention blocks are MQA (kv_heads=1) at full head_dim=256.  Every
    block ends in a GeGLU MLP; the LM head is omitted (see
    ``rwkv6_workload``).  ``seq=448`` leaves a ragged final chunk at
    chunk lengths >= 128 (448 % 128 == 64).
    """
    layers: List[Layer] = []
    t = seq
    h_lru = lru_width // heads

    def mlp(p: str, bi: int):
        layers.append(Layer(f"{p}.ln2", NORM, b=batch, c=dim, ox=t))
        layers.append(Layer(f"{p}.ff_gate", PWCONV, b=batch, k=ff, c=dim,
                            ox=t))
        layers.append(Layer(f"{p}.ff_up", PWCONV, b=batch, k=ff, c=dim,
                            ox=t, ibn_role="expand", ibn_id=4000 + bi))
        layers.append(Layer(f"{p}.ff_act", ACT, b=batch, c=ff, ox=t,
                            ibn_role="act", ibn_id=4000 + bi))
        layers.append(Layer(f"{p}.ff_down", PWCONV, b=batch, k=dim, c=ff,
                            ox=t, ibn_role="project", ibn_id=4000 + bi))
        layers.append(Layer(f"{p}.res2", ELEMWISE, b=batch, c=dim, ox=t))

    pattern = ("recurrent", "recurrent", "attention")
    for bi in range(n_layers):
        p = f"blk{bi}"
        kind = pattern[bi % len(pattern)]
        layers.append(Layer(f"{p}.ln1", NORM, b=batch, c=dim, ox=t))
        if kind == "recurrent":
            layers.append(Layer(f"{p}.linx", PWCONV, b=batch, k=lru_width,
                                c=dim, ox=t))
            layers.append(Layer(f"{p}.liny", PWCONV, b=batch, k=lru_width,
                                c=dim, ox=t))
            layers.append(Layer(f"{p}.ygelu", ACT, b=batch, c=lru_width,
                                ox=t))
            layers.append(Layer(f"{p}.conv1d", DWCONV, b=batch,
                                c=lru_width, ox=t, fx=conv1d_width))
            layers.append(Layer(f"{p}.gates", MATMUL, b=batch * heads,
                                k=2 * h_lru, c=h_lru, ox=t))
            layers.append(Layer(f"{p}.lru", SCAN, b=batch, ox=t, c=1,
                                k=lru_width))
            layers.append(Layer(f"{p}.gate_mul", ELEMWISE, b=batch,
                                c=lru_width, ox=t))
            layers.append(Layer(f"{p}.out", PWCONV, b=batch, k=dim,
                                c=lru_width, ox=t))
        else:
            layers.append(Layer(f"{p}.q", PWCONV, b=batch,
                                k=heads * head_dim, c=dim, ox=t))
            layers.append(Layer(f"{p}.kv", PWCONV, b=batch,
                                k=2 * head_dim, c=dim, ox=t))
            layers.append(Layer(f"{p}.qk", MATMUL, b=batch * heads, k=t,
                                c=head_dim, ox=t))
            layers.append(Layer(f"{p}.sm", SOFTMAX, b=batch * heads, c=t,
                                ox=t))
            layers.append(Layer(f"{p}.av", MATMUL, b=batch * heads,
                                k=head_dim, c=t, ox=t))
            layers.append(Layer(f"{p}.proj", PWCONV, b=batch, k=dim,
                                c=heads * head_dim, ox=t))
        layers.append(Layer(f"{p}.res1", ELEMWISE, b=batch, c=dim, ox=t))
        mlp(p, bi)
    layers.append(Layer("head.ln", NORM, b=batch, c=dim, ox=t))
    return layers


def total_macs(layers: List[Layer]) -> int:
    return sum(l.macs for l in layers)


def ibn_groups(layers: List[Layer]) -> List[Tuple[Layer, Layer, Layer]]:
    """(expand, act, project) triples, in order."""
    by_id: dict = {}
    for l in layers:
        if l.ibn_id >= 0:
            by_id.setdefault(l.ibn_id, {})[l.ibn_role] = l
    out = []
    for i in sorted(by_id):
        g = by_id[i]
        if {"expand", "act", "project"} <= set(g):
            out.append((g["expand"], g["act"], g["project"]))
    return out
