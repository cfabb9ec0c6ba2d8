"""Global-norm gradient clipping: port of ``repro/optim/clip.py``."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

Tree = Any


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's float32 sum of
    squares, summed leaf by leaf in tree order, as the reference sums."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The clip's factor of the gradients, min(1, max_norm / (norm +
    1e-9)), as a 0-d tensor of ``norm``'s type and device (the train step
    hands it to ``adamw_update``, which scales each gradient as it reads
    it)."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float, *,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads * min(1, max_norm / (norm + 1e-9)), norm).  The leaves are
    scaled in place (autograd's fresh gradients; a copy of the whole tree
    would cost as much memory as the parameters) and returned.  ``norm``:
    the global norm where the caller has it (a sharded step's, over the
    mesh), else ``global_norm(grads)``."""
    if norm is None:
        norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    with torch.no_grad():
        return tree_map(lambda g, path: g.mul_(scale.to(g.dtype)), grads), norm
