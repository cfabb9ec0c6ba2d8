"""Activation-sharding anchors: port of ``repro/models/actshard.py``.

In the JAX package these pin the canonical activation layout (batch over
the dp axes, heads or vocabulary over TP) where GSPMD would otherwise
propagate a costly one.  The port runs one program a rank, and the rank
already holds its block in that layout, so every anchor returns its input
unchanged, as the JAX anchors change no value.  They stand where the JAX
package calls them, so that a reader finds the counterpart.

``set_mesh`` installs the mesh (and profile) that ``layers.moe_apply_auto``
reads to pick the expert-parallel MoE; without one every helper is a
no-op.  The reference's ``_dp_entry`` (the batch dim's spec entry) is
``runtime.sharding._batch_axis``.
"""
from __future__ import annotations

_MESH = None
_PROFILE: str = "2d"


def set_mesh(mesh, profile: str = "2d") -> None:
    """Install (or clear, with None) the mesh of the ranks' program."""
    global _MESH, _PROFILE
    _MESH, _PROFILE = mesh, (profile if mesh is not None else "2d")


def current_profile() -> str:
    return _PROFILE


def current_mesh():
    return _MESH


def batch_sharded(x):
    """[B, ...]: batch over dp (and the sequence over 'model' under 'cp')."""
    return x


def attn_out_sharded(x):
    """[B, H, S, D] attention output: batch over dp, heads over TP."""
    return x


def logits_sharded(x):
    """[B, S, V]: batch over dp, vocabulary over TP."""
    return x
