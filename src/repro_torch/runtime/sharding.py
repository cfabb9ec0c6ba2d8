"""Mesh-aware sharding rules for parameters, batches and decode caches:
port of ``repro/runtime/sharding.py``.

Axis strategy, as in the JAX package:
  - ``pod``   : pure data parallelism (batch only; weights replicated
                across pods)
  - ``data``  : batch DP + FSDP/ZeRO weight and optimizer sharding
  - ``model`` : tensor parallel (heads / d_ff / vocab / experts) and
                sequence-parallel KV caches for decode
Divisibility fallbacks (a batch that dp does not divide, KV heads narrower
than TP, ...) demote the dim to replicated.

The specs are ``models.params.PartitionSpec``s, equal entry for entry to
the JAX package's.  ``local_shard`` and ``gather_full`` take the place of
``device_put(x, NamedSharding(mesh, spec))`` and of reading a sharded
array whole: a rank holds the block of a tensor that JAX's
``NamedSharding.devices_indices_map`` gives the device at its coordinates.
``shard_map`` has no counterpart: each rank runs the body itself.

The sharded steps' ``Layout`` says what a rank holds (its blocks of the
parameters, of the batch and, serving, of the decode cache) and which
products it splits over 'model'; ``gather_at_use`` is the hook a
layer calls on its leaves where it uses them (``models.actshard.gathered``),
gathering each over its fsdp axes, and counts the bytes it gathers and the
gathered bytes alive.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as param_lib
from repro_torch.models.params import PartitionSpec as P
from repro_torch.runtime import collectives

Tree = Any

PROFILES = ("2d", "fsdp", "tp", "cp")
# '2d'  : FSDP over 'data' x TP over 'model' (the default)
# 'fsdp': the whole mesh is one ZeRO/DP axis, no tensor parallelism
# 'tp'  : serving layout: weights TP-sharded over 'model', replicated over
#         'data'; batch on ('pod', 'data')
# 'cp'  : FSDP over 'data', the sequence dim of the batch over 'model'


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh, profile: str = "2d") -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first."""
    names = ("pod", "data", "model") if profile == "fsdp" else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def dp_size(mesh, profile: str = "2d") -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh, profile))


def _batch_axis(mesh, global_batch: int, profile: str = "2d"):
    """The spec entry for the batch dim: the largest prefix of the dp axes
    that divides the batch (None where none does)."""
    sizes = mesh_axis_sizes(mesh)
    chosen, prod = [], 1
    for a in dp_axes(mesh, profile):
        if global_batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def model_param_rules(cfg: ModelConfig, mesh, defs: Tree, *,
                      profile: str = "2d") -> Dict[str, Any]:
    """The logical -> mesh axis rules of ``model_param_pspecs``: the
    profile's, with every demotion applied."""
    sizes = mesh_axis_sizes(mesh)
    if profile == "fsdp":
        fsdp_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
        fsdp_axes = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
        tp_axis = None
    elif profile == "tp":
        fsdp_axes = None
        tp_axis = "model" if "model" in mesh.axis_names else None
    elif profile == "cp":
        fsdp_axes = "data" if "data" in mesh.axis_names else None
        tp_axis = None
    else:
        fsdp_axes = "data" if "data" in mesh.axis_names else None
        tp_axis = "model" if "model" in mesh.axis_names else None
    rules = param_lib.resolve_rules(
        sizes, kv_heads=cfg.num_kv_heads, num_heads=cfg.num_heads,
        fsdp_axes=fsdp_axes, tp_axis=tp_axis)

    # divisibility demotions beyond heads: a rule that some leaf's dim
    # does not divide is dropped for every leaf (odd d_ff, LRU widths)
    def check_leaf(d: param_lib.ParamDef):
        for ax, dim in zip(param_lib._axes(d), d.shape):
            mesh_ax = rules.get(ax or "null")
            if mesh_ax is not None and dim % param_lib._rule_size(mesh_ax, sizes):
                rules[ax] = None
    param_lib.tree_map_defs(check_leaf, defs)
    return rules


def model_param_pspecs(cfg: ModelConfig, mesh, defs: Tree, *,
                       profile: str = "2d") -> Tree:
    """PartitionSpec tree for a model's ParamDef tree on this mesh."""
    return param_lib.param_pspecs(
        defs, model_param_rules(cfg, mesh, defs, profile=profile))


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, mesh, batch_struct: Dict[str, Any],
                 profile: str = "2d") -> Dict[str, Any]:
    """PartitionSpecs for an input batch dict keyed by entry name (its
    values anything with ``shape`` and ``ndim``)."""
    sizes = mesh_axis_sizes(mesh)
    out: Dict[str, Any] = {}
    for k, v in batch_struct.items():
        ndim = len(v.shape)
        nb = _batch_axis(mesh, v.shape[0] if k != "positions" or ndim == 2
                         else v.shape[1], profile)
        sq = "model" if (profile == "cp" and ndim >= 2
                         and v.shape[1] % sizes.get("model", 1) == 0) else None
        if k in ("tokens", "labels", "loss_mask"):
            out[k] = P(nb, sq, *([None] * (ndim - 2))) if ndim >= 2 else P(nb)
        elif k == "inputs_embeds":
            out[k] = P(nb, sq, None)
        elif k == "positions" and ndim == 3:         # M-RoPE [3, B, S]
            out[k] = P(None, nb, sq)
        elif k == "positions":
            out[k] = P(nb, sq)
        else:
            out[k] = P(*([None] * ndim))
    return out


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _tpax(mesh, dim: int, profile: str):
    """'model' where the profile splits a cache dim over TP and the axis
    divides it, else None."""
    if profile == "fsdp":          # 'model' belongs to the batch/dp group
        return None
    return "model" if dim % mesh_axis_sizes(mesh).get("model", 1) == 0 else None


def cache_leaf_pspec(mesh, field: str, shape, profile: str = "2d") -> P:
    """The PartitionSpec of one leaf of a decode cache, by its NamedTuple
    field name and its (global) shape: ``cache_pspecs``' rule for a leaf."""
    ndim = len(shape)
    if ndim == 0:
        return P()
    shape = tuple(shape)
    tp = mesh_axis_sizes(mesh).get("model", 1)
    b_dim = 1 if ndim >= 4 or field.startswith("shift") else 0
    nb = _batch_axis(mesh, shape[b_dim], profile)
    if field in ("self_k", "self_v", "cross_k", "cross_v"):
        # Seamless [L,B,H,S,D]: heads over TP where they divide, else the
        # sequence
        if profile != "fsdp" and shape[2] % tp == 0:
            return P(None, nb, "model", None, None)
        return P(None, nb, None, _tpax(mesh, shape[3], profile), None)
    if field in ("k", "v"):                   # transformer [L,B,Hkv,S,D]
        return P(None, nb, None, _tpax(mesh, shape[3], profile), None)
    if field in ("attn_k", "attn_v"):         # RecurrentGemma [B,Hkv,W,D]
        return P(_batch_axis(mesh, shape[0], profile), None,
                 _tpax(mesh, shape[2], profile), None)
    if field == "state":                      # RWKV [L,B,H,K,V]
        return P(None, nb, _tpax(mesh, shape[2], profile), None, None)
    if field.startswith("shift"):             # RWKV [L,B,D]
        return P(None, nb, _tpax(mesh, shape[2], profile))
    if field == "rec_h":                      # RecurrentGemma [B,W]
        return P(_batch_axis(mesh, shape[0], profile), _tpax(mesh, shape[1], profile))
    if field == "conv_state":                 # RecurrentGemma [B,cw-1,W]
        return P(_batch_axis(mesh, shape[0], profile), None,
                 _tpax(mesh, shape[2], profile))
    return P(*([None] * ndim))


def cache_pspecs(cfg: ModelConfig, mesh, cache_struct: Any,
                 profile: str = "2d") -> Any:
    """PartitionSpec tree for a decode cache (a family's NamedTuple).  KV
    caches shard the batch over the dp axes and the sequence over TP;
    attention-free state shards its head dim over TP.  Dispatch is by the
    NamedTuple's field name (``cache_leaf_pspec``)."""
    if not hasattr(cache_struct, "_fields"):
        raise TypeError(f"cache_pspecs: a cache NamedTuple, got {type(cache_struct)}")
    out = {}
    for field in cache_struct._fields:
        sub = getattr(cache_struct, field)
        if isinstance(sub, (list, tuple)):
            out[field] = [cache_leaf_pspec(mesh, field, getattr(leaf, "shape", ()),
                                           profile) for leaf in sub]
        else:
            out[field] = cache_leaf_pspec(mesh, field, getattr(sub, "shape", ()),
                                          profile)
    return type(cache_struct)(**out)


# ---------------------------------------------------------------------------
# A rank's block of a tensor
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set:
    """The mesh axes a spec shards some dim over."""
    return {a for entry in spec for a in _entry_axes(entry)}


def shard_index(spec, mesh) -> Tuple[Tuple[int, int], ...]:
    """(index, count) a dim of a rank's block: a dim split over the axes
    of its entry is cut into their product of blocks, the first axis
    outermost, and the rank takes the block at its coordinates."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for entry in spec:
        idx, n = 0, 1
        for a in _entry_axes(entry):
            idx = idx * sizes[a] + mesh.coords[a]
            n *= sizes[a]
        out.append((idx, n))
    return tuple(out)


def local_shard(full, spec, mesh):
    """This rank's block of ``full`` (a tensor or a numpy array) under
    ``spec``: a view where the layout allows."""
    for dim, (idx, n) in enumerate(shard_index(spec, mesh)):
        if n == 1:
            continue
        size = full.shape[dim]
        if size % n:
            raise ValueError(f"local_shard: dim {dim} of {tuple(full.shape)} "
                             f"is not divisible by {n} ({spec})")
        step = size // n
        full = (full.narrow(dim, idx * step, step) if isinstance(full, torch.Tensor)
                else full[(slice(None),) * dim + (slice(idx * step, (idx + 1) * step),)])
    return full


def gather_full(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of ``local_shard``: the whole tensor on every rank, by an
    all-gather over each sharded dim's axes (innermost first)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            shard = collectives.all_gather(shard, mesh, a, dim)
    return shard


def tree_local_shard(tree: Tree, specs: Tree, mesh) -> Tree:
    return param_lib.tree_map(lambda x, s, path: local_shard(x, s, mesh), tree,
                              specs)


def tree_gather_full(tree: Tree, specs: Tree, mesh) -> Tree:
    return param_lib.tree_map(lambda x, s, path: gather_full(x, s, mesh), tree,
                              specs)


# ---------------------------------------------------------------------------
# The train step's layout: gathered at use, the rest kept as blocks
# ---------------------------------------------------------------------------


class Layout:
    """What a rank of a sharded train or serving step holds and splits.

    ``pspecs`` / ``defs`` / ``rules`` as ``model_param_pspecs`` lays the
    model out; ``tp`` the mesh where the profile splits products over
    'model' ('2d' and 'tp' with a 'model' axis of more than one rank),
    else None; ``whole`` the logical axes that stay on 'model' in the specs
    but whose products the model cannot split (RWKV-6's 'ff' and 'heads'
    where only one of them divides; d_ff where an MoE's experts do not),
    gathered over 'model' at use instead (KV heads divide 'model' only where
    the query heads do: their count divides the query heads'); ``dp`` the mesh's dp
    axes under the profile; ``rows_entry`` the current step's batch entry
    of its rows, ``batch_axes`` the axes they are split over, ``seq`` the
    mesh where the rows' sequence is split over 'model' (profile 'cp',
    'model' of more than one rank and dividing the sequence), else None,
    ``seq_split`` the batch entries whose sequence is, and ``batch_specs``
    the specs the rank takes its block of the batch by (``set_batch``);
    ``cache_dims`` the dim of each
    decode cache field that the rank holds its 'model' block of
    (``set_cache``, the serving steps)."""

    def __init__(self, cfg: ModelConfig, mesh, defs: Tree, profile: str = "2d"):
        self.mesh, self.defs = mesh, defs
        self.rules = model_param_rules(cfg, mesh, defs, profile=profile)
        self.pspecs = param_lib.param_pspecs(defs, self.rules)
        self.profile = profile
        self.dp = dp_axes(mesh, profile)
        self.dp_size = dp_size(mesh, profile)
        sizes = mesh_axis_sizes(mesh)
        self.tp = (mesh if profile in ("2d", "tp") and sizes.get("model", 1) > 1
                   else None)
        on = {k for k, v in self.rules.items() if v == "model"}
        whole = set()
        if cfg.family == "ssm" and ("ff" in on) != ("heads" in on):
            whole |= {"ff", "heads"}
        if cfg.moe.enabled and "expert" not in on and "ff" in on:
            whole.add("ff")
        self.whole = frozenset(whole & on)
        self.batch_axes: Tuple[str, ...] = ()
        self.rows_entry = "labels"
        self.seq = None
        self.seq_split: frozenset = frozenset()
        self.cache_dims: Dict[str, Optional[int]] = {}

    def set_batch(self, specs: Dict[str, Any]) -> None:
        """A step's batch layout from its entries' specs
        (``batch_pspecs``): the entry of its rows (``rows_entry``, the
        first of ``labels``, ``tokens`` and ``inputs_embeds`` that the batch
        has: a prefill or decode batch has no labels), the axes over which
        they are split (its first spec entry's), those of more than one
        rank, and under 'cp' the entries whose sequence is split over
        'model' (no other entry of a 'cp' batch spec names 'model';
        ``batch_pspecs`` keeps a sequence that 'model' does not divide
        whole).  Serving (no labels), the encoder-decoder's frames are split
        where their length divides 'model' though its rows' entry, a
        one-token decoder prefix, stays whole: each rank encodes its block
        of the frames.  In a train batch every entry's sequence is whole
        where the rows' is: the ranks of 'model' then hold the same
        tokens, frames included."""
        self.rows_entry = next(k for k in ("labels", "tokens", "inputs_embeds")
                               if k in specs)
        rows = specs[self.rows_entry]
        self.batch_axes = tuple(a for a in _entry_axes(rows[0])
                                if self.mesh.sizes[a] > 1)
        cp = self.profile == "cp" and self.mesh.sizes.get("model", 1) > 1
        split = frozenset(k for k, spec in specs.items()
                          if cp and "model" in spec_axes(spec))
        if "labels" in specs and self.rows_entry not in split:
            split = frozenset()         # a train step's loss is the rows'
        self.seq_split = split
        self.seq = self.mesh if self.rows_entry in split else None
        self.batch_specs = {
            k: spec if not cp or k in self.seq_split
            else P(*(None if e == "model" else e for e in spec))
            for k, spec in specs.items()}

    def set_cache(self, specs: Any) -> None:
        """A serving step's cache layout from its specs (``cache_pspecs``):
        for each field, the dim of one layer's leaf (a stacked leaf's slice,
        a list's element) past its rows (dim 0) that 'model' splits, where
        it has more than one rank, else None.  An attention cache's dim 1 is its KV heads, dim 2
        its slots (the sequence, or a ring's window): a prompt length that
        'model' does not divide leaves the slots whole."""
        self.cache_dims = {}
        if self.mesh.sizes.get("model", 1) == 1:
            return
        for field in specs._fields:
            spec = getattr(specs, field)
            spec = spec[0] if isinstance(spec, list) and spec else spec
            if not isinstance(spec, P):
                continue
            if not isinstance(getattr(specs, field), list):
                spec = spec[1:]                 # a stacked leaf's layer slice
            # dim 0 is the rows, which the batch's layout splits ('model'
            # among the rows' axes under 'fsdp')
            self.cache_dims[field] = next(
                (d for d, entry in enumerate(spec)
                 if d > 0 and "model" in _entry_axes(entry)), None)

    def cache_dim(self, field: str) -> Optional[int]:
        """The dim of one layer's leaf of the cache field that the rank
        holds its 'model' block of (``set_cache``), else None."""
        return self.cache_dims.get(field)

    def split(self, logical: str):
        """The mesh where the rank holds and computes its 'model' block of
        the logical axis, else None."""
        if self.tp is None or self.rules.get(logical) != "model" \
                or logical in self.whole:
            return None
        return self.tp

    def subtree(self, tree: Tree, path: str) -> Tree:
        """The subtree of ``tree`` (laid out as the parameters) at the
        dotted ``path``."""
        for key in path.split("."):
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        return tree


# bytes gathered at use since the count was last set to 0, and the bytes of
# gathered leaves alive now and at most (a leaf counts until its tensor is
# freed, views and autograd's saved copies of it included)
gathered_bytes = 0
live_gathered_bytes = 0
peak_live_gathered_bytes = 0


def reset_gather_counts() -> None:
    global gathered_bytes, peak_live_gathered_bytes
    gathered_bytes, peak_live_gathered_bytes = 0, live_gathered_bytes


def _freed(n: int) -> None:
    global live_gathered_bytes
    live_gathered_bytes -= n


def _count_gathered(t: torch.Tensor) -> torch.Tensor:
    global gathered_bytes, live_gathered_bytes, peak_live_gathered_bytes
    n = t.numel() * t.element_size()
    gathered_bytes += n
    live_gathered_bytes += n
    peak_live_gathered_bytes = max(peak_live_gathered_bytes, live_gathered_bytes)
    weakref.finalize(t, _freed, n)
    return t


def gather_at_use(tree: Tree, path: str, layout: Layout) -> Tree:
    """The leaves of ``tree`` (the subtree of the parameters at ``path``,
    a stacked block tree's layer slice allowed) as the rank computes with
    them: each dim gathered over its fsdp axes, innermost first, by
    ``collectives.all_gather``, whose adjoint hands each rank the sum of
    the ranks' gradients for its block; a dim on 'model' left as the
    rank's block where ``layout`` splits its products, else gathered by
    ``collectives.gather_from`` (the ranks of 'model' hold the same
    cotangent).  Called inside the function that ``layers.remat_call``
    wraps, so that the recompute gathers again and nothing whole outlives
    its layer."""
    specs, defs = layout.subtree(layout.pspecs, path), layout.subtree(layout.defs, path)
    mesh = layout.mesh

    def leaf(x: torch.Tensor, spec, d: param_lib.ParamDef, path: str) -> torch.Tensor:
        spec, axes = tuple(spec), param_lib._axes(d)
        if x.dim() == len(spec) - 1:             # a layer slice of a stacked leaf
            spec, axes = spec[1:], axes[1:]
        gathered = False
        for dim, (entry, logical) in enumerate(zip(spec, axes)):
            for a in reversed(_entry_axes(entry)):
                if a == "model" and layout.tp is not None:
                    if logical not in layout.whole:
                        continue
                    x = collectives.gather_from(x, mesh, a, dim)
                else:
                    x = collectives.all_gather(x, mesh, a, dim)
                gathered = gathered or mesh.sizes[a] > 1
        return _count_gathered(x) if gathered else x

    return param_lib.tree_map(leaf, tree, specs, defs)
