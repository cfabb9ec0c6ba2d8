"""Activation-sharding anchors and the sharded step's layout: port of
``repro/models/actshard.py``.

In the JAX package the anchors pin the canonical activation layout (batch
over the dp axes, heads or vocabulary over TP) where GSPMD would otherwise
propagate a costly one.  The port runs one program a rank, and under the
sharded train step that program already computes in the layout they pin:
the rank's rows of the batch, its heads of each attention (the q / k / v
projections are column-parallel over 'model'), its slice of the
vocabulary in the logits (``layers.lm_logits``).  So every anchor returns
its input unchanged, as the JAX anchors change no value; they stand where
the JAX package calls them, so that a reader finds the counterpart.

``set_mesh`` installs the mesh and profile of the ranks' program, and the
train step adds its ``runtime.sharding.Layout``.  ``layers.moe_apply_auto``
reads the mesh to pick the expert-parallel MoE; the layers read the
layout through ``split`` (which logical axes the rank computes its
'model' block of) and ``gathered`` (the gather-at-use hook); the loss
through ``dp``.  Without a mesh or a layout every helper is a no-op.  The
reference's ``_dp_entry`` (the batch dim's spec entry) is
``runtime.sharding._batch_axis``.
"""
from __future__ import annotations

_MESH = None
_PROFILE: str = "2d"
_LAYOUT = None


def set_mesh(mesh, profile: str = "2d", layout=None) -> None:
    """Install (or clear, with None) the mesh of the ranks' program, and
    the sharded train step's ``layout`` where given."""
    global _MESH, _PROFILE, _LAYOUT
    _MESH, _PROFILE = mesh, (profile if mesh is not None else "2d")
    _LAYOUT = layout if mesh is not None else None


def current_profile() -> str:
    return _PROFILE


def current_mesh():
    return _MESH


def current_layout():
    return _LAYOUT


def split(logical: str):
    """The mesh whose 'model' axis splits the products of ``logical``
    ('heads', 'kv_heads', 'ff', 'vocab', 'expert'): the rank holds and
    computes its block of them.  None without a layout, or where the
    layout keeps them whole."""
    return None if _LAYOUT is None else _LAYOUT.split(logical)


def gathered(tree, path: str):
    """``tree``, the parameters' subtree at ``path``, as the rank computes
    with it (``runtime.sharding.gather_at_use``); itself without a
    layout."""
    if _LAYOUT is None:
        return tree
    from repro_torch.runtime import sharding
    return sharding.gather_at_use(tree, path, _LAYOUT)


def dp():
    """(mesh, dp axes, dp size) of the installed layout, else None."""
    if _LAYOUT is None:
        return None
    return _LAYOUT.mesh, _LAYOUT.dp, _LAYOUT.dp_size


def batch_sharded(x):
    """[B, ...]: batch over dp (and the sequence over 'model' under 'cp')."""
    return x


def attn_out_sharded(x):
    """[B, H, S, D] attention output: batch over dp, heads over TP."""
    return x


def logits_sharded(x):
    """[B, S, V]: batch over dp, vocabulary over TP."""
    return x
