"""Int8 gradient compression with error feedback: port of
``repro/optim/compression.py``.  Quantize, dequantize, quantize with the
carried residual (so that compression error does not bias the gradient
direction), the zero residual tree, and ``compressed_pod_allreduce``, the
mean of the pods' partial gradients over the ``pod`` axis of a mesh, each
pod's partial quantized with its residual."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_map
from repro_torch.runtime import collectives

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale float32)."""
    absmax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_with_feedback(x: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: q(x + residual), new residual."""
    target = x.to(torch.float32) + residual
    q, scale = quantize_int8(target)
    new_residual = target - dequantize_int8(q, scale)
    return q, scale, new_residual


def init_feedback(grads: Tree) -> Tree:
    return tree_map(lambda g, path: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)


def compressed_pod_allreduce(pod_grads: Tree, feedback: Tree, mesh
                             ) -> Tuple[Tree, Tree]:
    """Mean-reduce the pods' partial gradients over the ``pod`` axis, int8
    with error feedback, on this rank.

    Each leaf is the rank's block of a [npods, ...] tree sharded over
    ``pod`` (a leading dim of 1: ``runtime.sharding.local_shard`` under
    ``P("pod", None, ...)``), and so is each residual.  The pod quantizes
    its partial with its carried residual, and the dequantized partials are
    summed over the axis (a float32 all-reduce, as the reference's
    ``psum`` of the dequantized values).  Returns (the mean, in the
    gradient's dtype, and the new residual), both [1, ...] blocks."""
    if "pod" not in mesh.axis_names:
        raise ValueError(f"compressed_pod_allreduce: no 'pod' axis in "
                         f"{mesh.axis_names}")
    npods = mesh.sizes["pod"]

    out = {}

    def leaf(g, r, path):
        q, scale, new_r = quantize_with_feedback(g[0], r[0])
        summed = collectives.psum(dequantize_int8(q, scale), mesh, "pod")
        out[path] = ((summed / npods).to(g.dtype)[None], new_r[None])

    tree_map(leaf, pod_grads, feedback)
    return (tree_map(lambda g, path: out[path][0], pod_grads),
            tree_map(lambda g, path: out[path][1], pod_grads))
