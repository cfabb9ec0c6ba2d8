"""AdamW over trees of tensors: port of ``repro/optim/adamw.py``.

b1 0.9, b2 0.95, eps 1e-8; weight decay on every leaf; the bias
corrections in float32 from the step count.  The moments are float32
tensors like the parameters.  One difference of form: ``adamw_update``
writes the new parameters and moments into the tensors it is given
(under ``torch.no_grad``, leaf by leaf, each product rounded where the
reference rounds it) and returns them, where the reference returns new
arrays; the reference's launcher donates both (``donate_argnums=(0, 1)``),
so neither keeps a second copy of the model's state.  A caller that needs
the old values keeps a copy.

Each leaf's update is one call of ``kernels.adamw_update`` (``kernels``:
``ops``, the default, or ``ref.PLAIN``): on the card one pass of the
hand-written kernel over the leaf, which reads the rate, the bias
corrections and the clip's factor (``scale``, from ``clip.clip_scale``)
from device memory; on the CPU its plain version.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.params import tree_leaves, tree_map

Tree = Any


class AdamWState(NamedTuple):
    count: torch.Tensor   # 0-d int32, on the parameters' device
    m: Tree               # first moment  (like params)
    v: Tree               # second moment (like params)


def adamw_init(params: Tree) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p, path):
        return torch.zeros_like(p, requires_grad=False)

    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_update(grads: Tree, state: AdamWState, params: Tree, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, scale: Optional[torch.Tensor] = None,
                 kernels=ops) -> Tuple[Tree, AdamWState]:
    """Returns (params, state), both updated in place (module docstring);
    the new count is a new tensor.  ``lr``: a float or a 0-d float32
    tensor; ``scale``: each gradient's factor before the update (the clip's,
    a 0-d float32 tensor), None for none.  A gradient that is not
    contiguous is copied into one that is (the kernel takes dense leaves);
    the gradients are not written."""
    with torch.no_grad():
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32, device=count.device)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            kernels.adamw_update(p, g.contiguous(), m, v, lr=lr, bc1=bc1, bc2=bc2,
                                 scale=scale, b1=b1, b2=b2, eps=eps,
                                 weight_decay=weight_decay)
        return params, AdamWState(count=count, m=state.m, v=state.v)
