"""Global-norm gradient clipping: port of ``repro/optim/clip.py``."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

Tree = Any


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's float32 sum of
    squares, summed leaf by leaf in tree order, as the reference sums."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads * min(1, max_norm / (norm + 1e-9)), norm).  The leaves are
    scaled in place (autograd's fresh gradients; a copy of the whole tree
    would cost as much memory as the parameters) and returned."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    with torch.no_grad():
        return tree_map(lambda g, path: g.mul_(scale.to(g.dtype)), grads), norm
