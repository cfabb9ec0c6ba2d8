"""Parameter trees of the port.

A model declares its parameters as a nested dict/list of ``ParamDef``
(shape, initialiser, scale), under the same nested names and in the same
layouts as the JAX package (``stages[i].conv_blocks[j].dw_w`` is
``[kh, kw, C]``, a pointwise weight is ``[Cin, Cout]``, ``temp`` is
``[heads, 1, 1]``).  From one definition tree:

- ``init_params``     : seeded numpy arrays, same shapes, initialisers and
                        scales as the JAX package's (not the same random
                        numbers: the two generators differ)
- ``from_jax_params`` : carries a tree of numpy arrays, such as the JAX
                        package's ``init_params`` turned to numpy, across
                        into a tree of tensors (``load_cast``: and casts
                        a model's compute-dtype leaves once)
- ``count_params``

The logical-axis / ``PartitionSpec`` half of the JAX module belongs to
the distributed runtime and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed | uniform_decay
    scale: Optional[float] = None  # stddev override; default fan-in scaling


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree,
             path: str = "") -> Tree:
    """Maps ``fn(leaf, *rest_leaves, path=...)`` over nested dicts/lists;
    ``rest`` must have the structure of ``tree``."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"structure differs at '{path}': expected "
                                 f"the keys {sorted(tree)}")
        return {k: tree_map(fn, v, *[r[k] for r in rest],
                            path=f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"structure differs at '{path}'")
        return [tree_map(fn, v, *[r[i] for r in rest], path=f"{path}.{i}")
                for i, v in enumerate(tree)]
    return fn(tree, *rest, path=path)


def tree_leaves(tree: Tree) -> list:
    out: list = []
    tree_map(lambda leaf, path: out.append(leaf), tree)
    return out


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    return max(1, math.prod(shape[:-1]))   # contraction dims = all but the last


def _init_leaf(rng: np.random.Generator, d: ParamDef,
               perturb: float = 0.0) -> np.ndarray:
    if d.init in ("zeros", "ones"):
        # as in the JAX package: ``scale`` does not apply to zeros/ones
        base = np.zeros if d.init == "zeros" else np.ones
        a = base(d.shape, np.float32)
        if perturb:
            a += perturb * rng.standard_normal(d.shape, dtype=np.float32)
        return a
    if d.init == "uniform_decay":
        # decay-parameter init in (-6, -3) log space (RWKV/LRU style)
        return (-6.0 + 3.0 * rng.random(d.shape, dtype=np.float32)
                ).astype(np.float32)
    if d.init not in ("normal", "embed"):
        raise ValueError(d.init)
    scale = d.scale
    if scale is None:
        scale = 1.0 if d.init == "embed" else 1.0 / math.sqrt(_fan_in(d.shape))
    return (scale * rng.standard_normal(d.shape, dtype=np.float32)
            ).astype(np.float32)


def init_params(seed: int, defs: Tree, *, perturb: float = 0.0) -> Tree:
    """Seeded numpy parameters for a definition tree.  ``perturb`` adds
    normal noise of that stddev to the zeros/ones leaves, so that a run on
    random weights also exercises the biases, scales and layer scales that
    an untrained initialisation leaves neutral."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda d, path: _init_leaf(rng, d, perturb), defs)


def from_jax_params(tree: Tree, defs: Optional[Tree] = None, *,
                    device: "torch.device | str" = "cuda",
                    dtype: torch.dtype = torch.float32) -> Tree:
    """A tree of numpy arrays (the JAX package's parameters, names and
    layouts unchanged) -> the same tree of tensors on ``device``.  With
    ``defs`` given, structure and every shape are checked against it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params: device='cuda' but no CUDA "
                           "device is available (pass device='cpu')")

    def leaf(a, path):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)  # a copy

    def check(d, a, path):
        if tuple(np.shape(a)) != tuple(d.shape):
            raise ValueError(f"{path}: shape {np.shape(a)}, "
                             f"expected {d.shape}")

    if defs is not None:
        tree_map(check, defs, tree)
    return tree_map(leaf, tree)


def load_cast(cfg, tree: Tree, defs: Tree, cast_leaves, *,
              device: "torch.device | str" = "cuda") -> Tree:
    """A model's ``load_params``: a tree of numpy arrays (``init_params`` or
    the JAX package's parameters) -> tensors on ``device`` (the card by
    default; raises without one), float32, with the leaves at the paths
    ``cast_leaves`` cast once to ``cfg.compute_dtype`` (the rounding of the
    reference's cast at each use).  A tied embedding stays float32: the LM
    head reads it in float32.  TF32 products are switched off, so that a
    float32 product on the card is exact float32, as the reference's is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cast = set(cast_leaves) - ({"embed.embedding"} if cfg.tie_embeddings else set())
    return tree_map(lambda t, path: t.to(cfg.compute_dtype) if path in cast else t,
                    from_jax_params(tree, defs, device=device))


def per_layer(blocks: Tree, n: int) -> list:
    """A stacked [L, ...] block tree -> one tree of views per layer (one
    ``unbind`` a leaf): the port walks the layers that the JAX models scan."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: parts[k][i] for k in tree} for i in range(n)]
        return torch.unbind(tree, 0)
    return split(blocks)


def count_params(defs: Tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))
