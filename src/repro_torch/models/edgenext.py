"""EdgeNeXt-S [arXiv:2206.10589] — the paper's benchmark hybrid ViT.

Port of ``repro/models/edgenext.py``.  Stem (4x4 s4 patchify) -> 4 stages
of conv encoder blocks (inverted bottlenecks behind a kxk depthwise conv)
with an SDTA block (split depthwise cascade + transposed channel
attention, XCA) at the end of stages 2-4; 2x2 s2 downsample between
stages; global-pool classifier head.  Inference only.

All tensors are channels-last [B, H, W, C].  Parameters are a nested
dict/list with the JAX package's names and layouts (``params.py``).

Where the work goes, decided by the tensor's device and by nothing else:

- every depthwise conv -> ``ops.depthwise_conv2d``;
- every inverted-bottleneck MLP -> ``ops.fused_ibn``: the kernel has no
  inner bias, so ``pw1_b`` is folded in as one more input row (x gets a
  column of ones) and ``pw2_b`` is added after;
- XCA -> ``ops.flash_attention`` with ``causal=False, scale=1.0`` on
  [B, h, C/h, N] (the sequence is the channels of a head, the head dim is
  the tokens); q and k are L2-normalised over N in float32 outside the
  kernel and ``temp[h]`` is multiplied into q;
- ``ibn_chunks > 1`` is the tensor-level depth-first schedule of the MLP
  (tiles over the expanded dim, plain products), kept for parity with the
  reference; it does not go through a kernel.

On a CPU tensor ``ops`` runs the plain versions, on a CUDA tensor the
hand-written kernels.  The patchify/downsample convolutions (kernel =
stride, VALID) and the qkv/proj/head products are outside any kernel in
the JAX package too and are ``torch.matmul`` on a reshape: no cuDNN
convolution, which would run float32 in TF32 by default.  ``EdgeNeXt``
sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` when it is built, so float32
products are exact float32.

Simplifications as in the reference: no stochastic depth, no positional
embedding on the first SDTA block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.edgenext_s import EdgeNeXtConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef, from_jax_params, tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Functional conv / norm helpers (channels-last)
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """x: [B,H,W,Cin], w: [kh,kw,Cin,Cout].  Only the patchify form the
    model uses: kernel = stride, VALID, H and W multiples of the stride —
    a reshape and one matrix product."""
    kh, kw, cin, cout = w.shape
    B, H, W, _ = x.shape
    if padding != "VALID" or kh != stride or kw != stride \
            or H % stride or W % stride:
        raise NotImplementedError(
            f"conv2d: only kernel == stride, VALID is ported "
            f"(kernel {kh}x{kw}, stride {stride}, {padding}, input {H}x{W})")
    patches = x.reshape(B, H // kh, kh, W // kw, kw, cin) \
               .permute(0, 1, 3, 2, 4, 5) \
               .reshape(B, H // kh, W // kw, kh * kw * cin)
    return patches @ w.reshape(kh * kw * cin, cout) + b


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     kernels=ops) -> torch.Tensor:
    """x: [B,H,W,C], w: [kh,kw,C] — per-channel SAME conv."""
    return kernels.depthwise_conv2d(x, w, b)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Over the last dim, eps 1e-6, biased variance, statistics in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _ln_defs(c: int) -> Params:
    return {"scale": ParamDef((c,), "ones", axes=("embed",)),
            "bias": ParamDef((c,), "zeros", axes=("embed",))}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _conv_block_defs(c: int, k: int, expan: int) -> Params:
    return {
        "dw_w": ParamDef((k, k, c), axes=(None, None, "embed")),
        "dw_b": ParamDef((c,), "zeros", axes=("embed",)),
        "ln": _ln_defs(c),
        "pw1_w": ParamDef((c, expan * c), axes=("embed", "ff")),
        "pw1_b": ParamDef((expan * c,), "zeros", axes=("ff",)),
        "pw2_w": ParamDef((expan * c, c), axes=("ff", "embed")),
        "pw2_b": ParamDef((c,), "zeros", axes=("embed",)),
        "gamma": ParamDef((c,), "ones", scale=1e-6, axes=("embed",)),
    }


def _sdta_defs(c: int, heads: int, scales: int, expan: int) -> Params:
    # hierarchical dw convs act on the (scales-1) later channel splits
    widths = _split_widths(c, scales)
    dw = [{"w": ParamDef((3, 3, w), axes=(None, None, "embed")),
           "b": ParamDef((w,), "zeros", axes=("embed",))}
          for w in widths[1:]]
    return {
        "dw": dw,
        "ln_x": _ln_defs(c),
        "qkv_w": ParamDef((c, 3 * c), axes=("embed", "ff")),
        "qkv_b": ParamDef((3 * c,), "zeros", axes=("ff",)),
        "temp": ParamDef((heads, 1, 1), "ones", axes=(None, None, None)),
        "proj_w": ParamDef((c, c), axes=("ff", "embed")),
        "proj_b": ParamDef((c,), "zeros", axes=("embed",)),
        "gamma_x": ParamDef((c,), "ones", scale=1e-6, axes=("embed",)),
        "ln_m": _ln_defs(c),
        "pw1_w": ParamDef((c, expan * c), axes=("embed", "ff")),
        "pw1_b": ParamDef((expan * c,), "zeros", axes=("ff",)),
        "pw2_w": ParamDef((expan * c, c), axes=("ff", "embed")),
        "pw2_b": ParamDef((c,), "zeros", axes=("embed",)),
        "gamma_m": ParamDef((c,), "ones", scale=1e-6, axes=("embed",)),
    }


def _split_widths(c: int, scales: int) -> List[int]:
    """Res2Net-style channel split widths (last split takes the remainder)."""
    if scales == 1:
        return [c]
    base = int(math.ceil(c / scales))
    widths = [base] * (scales - 1)
    widths.append(c - base * (scales - 1))
    return widths


def param_defs(cfg: EdgeNeXtConfig) -> Params:
    stages: List[Params] = []
    for si in range(4):
        c = cfg.dims[si]
        k = cfg.kernel_sizes[si]
        n_conv = cfg.depths[si] - cfg.sdta_blocks[si]
        stage: Params = {
            "conv_blocks": [_conv_block_defs(c, k, cfg.expan_ratio)
                            for _ in range(n_conv)],
            "sdta_blocks": [_sdta_defs(c, cfg.heads, cfg.sdta_scales[si],
                                       cfg.expan_ratio)
                            for _ in range(cfg.sdta_blocks[si])],
        }
        if si == 0:
            stage["down_w"] = ParamDef((4, 4, cfg.in_channels, c),
                                       axes=(None, None, None, "embed"))
            stage["down_b"] = ParamDef((c,), "zeros", axes=("embed",))
        else:
            cp = cfg.dims[si - 1]
            stage["down_ln"] = _ln_defs(cp)
            stage["down_w"] = ParamDef((2, 2, cp, c), axes=(None, None, "embed", "ff"))
            stage["down_b"] = ParamDef((c,), "zeros", axes=("ff",))
        stages.append(stage)
    return {
        "stages": stages,
        "head_ln": _ln_defs(cfg.dims[-1]),
        "head_w": ParamDef((cfg.dims[-1], cfg.num_classes), axes=("embed", "vocab")),
        "head_b": ParamDef((cfg.num_classes,), "zeros", axes=("vocab",)),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ibn_mlp(bp: Params, x: torch.Tensor, ibn_chunks: int = 0,
             kernels=ops) -> torch.Tensor:
    """Pointwise inverted bottleneck: pw-expand -> GELU -> pw-project.

    Default: the fused kernel, inner bias folded in as an input row.
    ``ibn_chunks > 1``: depth-first tiles over the expanded dim with plain
    products (live tile bounded to d_ff/ibn_chunks).
    """
    dtype = x.dtype
    w1 = bp["pw1_w"].to(dtype)
    b1 = bp["pw1_b"].to(dtype)
    w2 = bp["pw2_w"].to(dtype)
    b2 = bp["pw2_b"].to(dtype)
    if ibn_chunks <= 1:
        ones = torch.ones(x.shape[:-1] + (1,), dtype=dtype, device=x.device)
        return kernels.fused_ibn(torch.cat([x, ones], -1),
                                 torch.cat([w1, b1[None]], 0), w2,
                                 activation="gelu") + b2
    f = w1.shape[-1]
    assert f % ibn_chunks == 0
    tile = f // ibn_chunks
    out = b2.expand(x.shape[:-1] + (w2.shape[-1],)).clone()
    for i in range(ibn_chunks):
        sl = slice(i * tile, (i + 1) * tile)
        t = F.gelu(x @ w1[:, sl] + b1[sl], approximate="tanh")
        out += t @ w2[sl]
    return out


def conv_encoder_block(bp: Params, x: torch.Tensor, ibn_chunks: int = 0,
                       kernels=ops) -> torch.Tensor:
    """dw conv kxk -> LN -> pw 4x -> GELU -> pw -> layer scale -> residual."""
    h = depthwise_conv2d(x, bp["dw_w"].to(x.dtype), bp["dw_b"].to(x.dtype),
                         kernels)
    h = layer_norm(h, bp["ln"]["scale"], bp["ln"]["bias"])
    h = _ibn_mlp(bp, h, ibn_chunks, kernels)
    return x + bp["gamma"].to(x.dtype) * h


def xca(bp: Params, x: torch.Tensor, heads: int, kernels=ops) -> torch.Tensor:
    """Cross-covariance (transposed) attention over the channel dim.

    x: [B,N,C].  The attention matrix is [C/h, C/h] per head — channel
    mixing with a reduction over the tokens — so it is attention with the
    channels of a head as the sequence and the N tokens as the head dim.
    """
    B, N, C = x.shape
    dtype = x.dtype
    qkv = x @ bp["qkv_w"].to(dtype) + bp["qkv_b"].to(dtype)
    qkv = qkv.reshape(B, N, 3, heads, C // heads)
    # q, k, v: [B, h, C/h, N]
    q, k, v = [qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3)]
    qf = q.float()
    kf = k.float()
    qf = qf / (torch.linalg.vector_norm(qf, dim=-1, keepdim=True) + 1e-6)
    kf = kf / (torch.linalg.vector_norm(kf, dim=-1, keepdim=True) + 1e-6)
    qf = qf * bp["temp"].float()            # temp[h] scales row h's scores
    out = kernels.flash_attention(
        qf.to(dtype).contiguous(), kf.to(dtype).contiguous(),
        v.contiguous(), causal=False, scale=1.0)
    out = out.permute(0, 3, 1, 2).reshape(B, N, C)
    return out @ bp["proj_w"].to(dtype) + bp["proj_b"].to(dtype)


def sdta_block(bp: Params, x: torch.Tensor, heads: int, scales: int,
               ibn_chunks: int = 0, kernels=ops) -> torch.Tensor:
    """Split-depthwise cascade + XCA + inverted-bottleneck MLP."""
    B, H, W, C = x.shape
    dtype = x.dtype
    widths = _split_widths(C, scales)
    if scales > 1:
        # channel slices of x: views, which the depthwise kernel takes as
        # they are (it is given the distance between pixels)
        splits = torch.split(x, widths, dim=-1)
        outs = [splits[0]]
        prev = None
        for i, sp in enumerate(splits[1:]):
            # The last split may be narrower than the others (160 channels
            # over 3 scales: 54, 54, 52).  The reference adds `prev` whole
            # and so cannot run such a stage; here the cascade carries the
            # channels the two have in common, which is the same sum
            # wherever the reference runs.
            inp = sp if prev is None else sp + prev[..., :sp.shape[-1]]
            prev = depthwise_conv2d(inp, bp["dw"][i]["w"].to(dtype),
                                    bp["dw"][i]["b"].to(dtype), kernels)
            outs.append(prev)
        h = torch.cat(outs, dim=-1)
    else:
        h = x
    # transposed attention on flattened tokens
    hn = h.reshape(B, H * W, C)
    a = layer_norm(hn, bp["ln_x"]["scale"], bp["ln_x"]["bias"])
    a = xca(bp, a, heads, kernels)
    hn = hn + bp["gamma_x"].to(dtype) * a
    # inverted-bottleneck MLP
    m = layer_norm(hn, bp["ln_m"]["scale"], bp["ln_m"]["bias"])
    m = _ibn_mlp(bp, m, ibn_chunks, kernels)
    hn = hn + bp["gamma_m"].to(dtype) * m
    return hn.reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def forward(cfg: EdgeNeXtConfig, params: Params, images: torch.Tensor, *,
            ibn_chunks: int = 0, kernels=ops) -> torch.Tensor:
    """images: [B, img, img, 3] -> logits [B, num_classes] (float32)."""
    x = images.to(getattr(torch, cfg.dtype))
    for si in range(4):
        sp = params["stages"][si]
        if si == 0:
            x = conv2d(x, sp["down_w"].to(x.dtype), sp["down_b"].to(x.dtype),
                       stride=4, padding="VALID")
        else:
            x = layer_norm(x, sp["down_ln"]["scale"], sp["down_ln"]["bias"])
            x = conv2d(x, sp["down_w"].to(x.dtype), sp["down_b"].to(x.dtype),
                       stride=2, padding="VALID")
        for bp in sp["conv_blocks"]:
            x = conv_encoder_block(bp, x, ibn_chunks, kernels)
        for bp in sp["sdta_blocks"]:
            x = sdta_block(bp, x, cfg.heads, cfg.sdta_scales[si], ibn_chunks,
                           kernels)
    x = x.mean(dim=(1, 2))                                    # global pool
    x = layer_norm(x, params["head_ln"]["scale"], params["head_ln"]["bias"])
    return (x @ params["head_w"].to(x.dtype)
            + params["head_b"].to(x.dtype)).float()


def kernel_launches_per_forward(cfg: EdgeNeXtConfig) -> Dict[str, int]:
    """How many times one ``forward`` (``ibn_chunks=0``) calls each kernel."""
    n_sdta = sum(cfg.sdta_blocks)
    return {
        "fused_ibn": sum(cfg.depths),
        "depthwise_conv2d": sum(
            (cfg.depths[si] - cfg.sdta_blocks[si])
            + cfg.sdta_blocks[si] * (cfg.sdta_scales[si] - 1)
            for si in range(4)),
        "flash_attention": n_sdta,
    }


class EdgeNeXt(nn.Module):
    """``forward`` with its weights held as module state.

    ``params`` is a nested dict/list of numpy arrays (``params.init_params``
    or the JAX package's parameters as numpy).  ``device`` defaults to the
    card and the constructor raises if there is none; pass
    ``device="cpu"`` to run the plain versions.  ``kernels`` is the
    namespace the three kernel calls go through: ``ops`` (the default) or
    ``ref.PLAIN`` to run the same composition without any kernel.
    """

    def __init__(self, cfg: EdgeNeXtConfig, params: Params, *,
                 device: "torch.device | str" = "cuda", kernels=ops):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.kernels = kernels
        self._defs = param_defs(cfg)
        # the leaves under their dotted names ('.' -> '/'), so that
        # state_dict(), .to() and parameters() see them
        self.weights = nn.ParameterDict()
        tree_map(self._register,
                 from_jax_params(params, self._defs, device=device))

    def _register(self, t: torch.Tensor, path: str) -> None:
        self.weights[path.replace(".", "/")] = nn.Parameter(
            t, requires_grad=False)

    def params_tree(self) -> Params:
        """The weights as the nested dict/list the functions above take."""
        return tree_map(lambda d, path: self.weights[path.replace(".", "/")],
                        self._defs)

    def forward(self, images: torch.Tensor, *,
                ibn_chunks: int = 0) -> torch.Tensor:
        dev = self.weights["head_b"].device
        if images.device != dev:
            raise ValueError(f"images on {images.device}, model on {dev}")
        return forward(self.cfg, self.params_tree(), images,
                       ibn_chunks=ibn_chunks, kernels=self.kernels)
