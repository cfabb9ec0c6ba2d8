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
sharded steps add their ``runtime.sharding.Layout``: the train step, and
the serving steps (``runtime.steps.build_prefill_step`` /
``build_decode_step`` under a mesh), whose layout also lays out the decode
cache.  ``layers.moe_apply_auto``
reads the mesh to pick the expert-parallel MoE; the layers read the
layout through ``split`` (which logical axes the rank computes its
'model' block of), ``gathered`` (the gather-at-use hook) and ``seq``
(whether the batch's sequence is split over 'model', profile 'cp'); the
loss through ``dp``; prefill and decode through ``cache_split`` (which dim
of a cache leaf the rank holds its 'model' block of: an attention cache's
slots or its KV heads, a recurrent state's heads or channels) and
``to_cache`` / ``from_cache``, which carry a leaf between the block the
rank computes and the one it holds; a 'cp' prefill through ``seq_len``
and ``seq_last`` (what the last rank's block leaves, moved into the
cache's blocks).  Without a mesh or a layout every
helper is a no-op.  The
reference's ``_dp_entry`` (the batch dim's spec entry) is
``runtime.sharding._batch_axis``.
"""
from __future__ import annotations

import torch

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
    """(mesh, axes, count) of the installed layout over which a rank's loss
    is its share of the global mean: the dp axes and their size, with
    'model' and its size too where the batch's sequence is split over it
    (``seq``); else None."""
    if _LAYOUT is None:
        return None
    if _LAYOUT.seq is None:
        return _LAYOUT.mesh, _LAYOUT.dp, _LAYOUT.dp_size
    n = _LAYOUT.mesh.sizes["model"]
    return _LAYOUT.mesh, _LAYOUT.dp + ("model",), _LAYOUT.dp_size * n


def seq(entry: str | None = None):
    """(mesh, this rank's coordinate r on 'model', the count n of 'model')
    where the sharded step splits the sequence of the batch's ``entry``
    (by default the entry of its rows: ``labels`` in training, the
    prompt's ``tokens`` or ``inputs_embeds`` serving) over 'model' (profile
    'cp'; ``runtime.sharding.Layout.set_batch``): the rank holds positions
    r S/n ... (r + 1) S/n - 1 of its rows.  None without a layout, and
    where the sequence is whole on every rank."""
    if _LAYOUT is None or (entry or _LAYOUT.rows_entry) not in _LAYOUT.seq_split:
        return None
    mesh = _LAYOUT.mesh
    return mesh, mesh.coords["model"], mesh.sizes["model"]


def positions(S: int, device, entry: str | None = None):
    """The absolute positions [S] of the rank's S tokens of ``entry``:
    ``arange(S)``, offset by r S under ``seq``."""
    sq = seq(entry)
    start = 0 if sq is None else sq[1] * S
    return torch.arange(start, start + S, device=device)


def seq_len(S: int, entry: str | None = None) -> int:
    """The whole sequence's length of which the rank holds ``S`` positions
    (n S under ``seq``)."""
    sq = seq(entry)
    return S if sq is None else S * sq[2]


def cache_split(field: str):
    """(mesh, dim, r, n) where the installed serving layout holds the
    rank's 'model' block of one layer's leaf of the decode cache's
    ``field`` along ``dim`` (``runtime.sharding.Layout.set_cache``): block
    r of n.  None without a layout, and where the leaf is whole over
    'model'."""
    if _LAYOUT is None:
        return None
    dim = _LAYOUT.cache_dim(field)
    if dim is None:
        return None
    mesh = _LAYOUT.mesh
    return mesh, dim, mesh.coords["model"], mesh.sizes["model"]


def to_cache(field: str, x, split_dim=None):
    """``x``, one layer's leaf of the cache ``field`` as the rank computed
    it (whole, or its 'model' block along ``split_dim``: of the heads or
    channels, or under 'cp' of the sequence, an attention cache's slots),
    as the rank holds it (``cache_split``): nothing moves where the cache
    splits the same dim (a linear attention cache of the prompt's length
    takes each rank's block of the sequence as its block of slots),
    gathered over 'model' where the cache keeps that dim whole, the rank's
    block cut where the cache splits a dim the rank computed whole.  ``x``
    itself without a layout."""
    if _LAYOUT is None:
        return x
    from repro_torch.runtime import collectives as C
    cs = cache_split(field)
    if split_dim is not None and (cs is None or cs[1] != split_dim % x.dim()):
        x = C.gather_from(x, _LAYOUT.mesh, "model", split_dim)
        split_dim = None
    if cs is not None and split_dim is None:
        _, dim, r, n = cs
        step = x.shape[dim] // n
        x = x.narrow(dim, r * step, step).clone(memory_format=torch.contiguous_format)
    return x


def from_cache(field: str, x, split_dim=None):
    """The inverse of ``to_cache``: one layer's leaf of the cache ``field``
    as the rank holds it -> as the rank computes with it (whole, or its
    'model' block along ``split_dim``)."""
    if _LAYOUT is None:
        return x
    from repro_torch.runtime import collectives as C
    cs = cache_split(field)
    if cs is not None and (split_dim is None or cs[1] != split_dim % x.dim()):
        x = C.gather_from(x, _LAYOUT.mesh, "model", cs[1])
        cs = None
    if split_dim is not None and cs is None:
        mesh = _LAYOUT.mesh
        n = mesh.sizes["model"]
        step = x.shape[split_dim] // n
        x = x.narrow(split_dim, mesh.coords["model"] * step, step)
    return x


def seq_last(x, field: str | None = None, split_dim=None):
    """``x``, a value that the sequence leaves at its end (the last hidden
    state, a recurrence's final state, a token shift), as the rank holds
    it: ``to_cache(field, x, split_dim)``, or ``x`` itself without a
    ``field``.  Under ``seq`` ``x`` is what the rank's own block of the
    sequence left, and the sequence's is the last rank of 'model''s: it
    goes whole to every rank (``collectives.from_last``), or where the
    cache splits the ``field`` over 'model', to rank r only its block r
    (``collectives.scatter_from_last``)."""
    sq = seq()
    if sq is None:
        return x if field is None else to_cache(field, x, split_dim)
    from repro_torch.runtime import collectives as C
    cs = None if field is None else cache_split(field)
    if cs is None:
        return C.from_last(x, sq[0], "model")
    return C.scatter_from_last(x, sq[0], "model", cs[1])


def batch_sharded(x):
    """[B, S, ...]: batch over dp (and the sequence over 'model' under
    'cp'); the rank's program holds that block already (``seq``)."""
    return x


def attn_out_sharded(x):
    """[B, H, S, D] attention output: batch over dp, heads over TP."""
    return x


def logits_sharded(x):
    """[B, S, V]: batch over dp, vocabulary over TP."""
    return x
