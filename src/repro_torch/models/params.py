"""Parameter trees of the port.

A model declares its parameters as a nested dict/list of ``ParamDef``
(shape, initialiser, scale), under the same nested names and in the same
layouts as the JAX package (``stages[i].conv_blocks[j].dw_w`` is
``[kh, kw, C]``, a pointwise weight is ``[Cin, Cout]``, ``temp`` is
``[heads, 1, 1]``).  From one definition tree:

- ``init_params``     : seeded numpy arrays, same shapes, initialisers and
                        scales as the JAX package's (not the same random
                        numbers: the two generators differ)
- ``init_on_device``  : the same initialisers drawn on the device, one layer
                        slice at a time into the served dtypes (the
                        reference's launcher jits its ``init_params`` onto
                        the device); each model's ``init_on_device`` wraps it
- ``from_jax_params`` : carries a tree of numpy arrays, such as the JAX
                        package's ``init_params`` turned to numpy, across
                        into a tree of tensors (``load_cast``: and casts
                        a model's compute-dtype leaves once)
- ``count_params``
- ``param_pspecs``    : a ``PartitionSpec`` a leaf, from the leaf's logical
                        axes and the logical -> mesh axis rules

Logical axis names, as in the JAX package:

  ``embed``    d_model rows of weight matrices         -> FSDP axis ("data")
  ``ff``       FFN hidden / per-head fanout columns    -> TP axis ("model")
  ``heads``    attention Q-head dim                    -> TP axis ("model")
  ``kv_heads`` attention KV-head dim                   -> TP axis iff divisible
  ``vocab``    vocabulary dim                          -> TP axis ("model")
  ``expert``   MoE expert dim                          -> TP axis (expert parallel)
  ``layers``   stacked-layer dim                       -> never sharded
  ``null``     anything else                           -> never sharded
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed | uniform_decay
    scale: Optional[float] = None  # stddev override; default fan-in scaling
    axes: Optional[Tuple[Optional[str], ...]] = None   # logical axis a dim

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"ParamDef: axes {self.axes} for shape {self.shape}")


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree,
             path: str = "") -> Tree:
    """Maps ``fn(leaf, *rest_leaves, path=...)`` over nested dicts/lists;
    ``rest`` must have the structure of ``tree``.  A ``PartitionSpec`` is a
    leaf."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"structure differs at '{path}': expected "
                                 f"the keys {sorted(tree)}")
        return {k: tree_map(fn, v, *[r[k] for r in rest],
                            path=f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
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


def _check_device(device: torch.device, fn: str) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: device='cuda' but no CUDA device is "
                           f"available (pass device='cpu')")


def _draw(d: ParamDef, shape: Tuple[int, ...], gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
    """One float32 draw of ``d``'s initialiser at ``shape`` (a whole leaf or
    one layer slice of it), with the scale of the whole leaf."""
    if d.init in ("zeros", "ones"):
        # as in the JAX package: ``scale`` does not apply to zeros/ones
        fill = torch.zeros if d.init == "zeros" else torch.ones
        return fill(shape, dtype=torch.float32, device=device)
    if d.init == "uniform_decay":
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return -6.0 + 3.0 * u
    if d.init not in ("normal", "embed"):
        raise ValueError(d.init)
    scale = d.scale
    if scale is None:
        scale = 1.0 if d.init == "embed" else 1.0 / math.sqrt(_fan_in(d.shape))
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=device)


def _slice_seed(seed: int, leaf: int, layer: int) -> int:
    """The generator's seed of one draw: (seed, the leaf's index in tree
    order, the layer index; 0 for a leaf that is not stacked)."""
    return int(np.random.SeedSequence([seed, leaf, layer]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def init_on_device(seed: int, defs: Tree, *,
                   device: "torch.device | str" = "cuda", cast_leaves=(),
                   compute_dtype: Optional[torch.dtype] = None,
                   layers: Optional[int] = None) -> Tree:
    """Seeded parameters drawn on ``device`` by a ``torch.Generator`` there,
    with the initialisers and scales of ``init_params`` (and of the JAX
    package's ``init_params``, which the reference's launcher jits onto the
    device): a tree of tensors, ready for a model's ``load_params``.

    Each draw has a generator of its own, seeded by (``seed``, the leaf's
    index in tree order, the layer index).  A stacked leaf (first axis
    ``layers``) is drawn one layer slice at a time in float32 and copied
    into a tensor made in its final dtype, so that the peak is the tree as
    served plus one float32 slice.  The leaves at the paths ``cast_leaves``
    get ``compute_dtype`` (the rounding of the float32 draw, as
    ``load_cast`` rounds it), every other leaf float32.  ``layers=n`` draws
    only the first n slices of each stacked leaf: the same float32 numbers
    that the whole draw rounds.

    The numbers are not ``init_params``': the card's generator (Philox),
    the CPU's (Mersenne Twister) and numpy's all differ, and none of them
    is the reference's ``jax.random`` stream.  ``device="cuda"`` raises
    where there is no card."""
    device = torch.device(device)
    _check_device(device, "init_on_device")
    gen = torch.Generator(device=device)
    cast = set(cast_leaves)
    index = itertools.count()

    def leaf(d: ParamDef, path: str) -> torch.Tensor:
        i = next(index)
        dtype = compute_dtype if compute_dtype is not None and path in cast \
            else torch.float32
        if not d.axes or d.axes[0] != "layers":
            gen.manual_seed(_slice_seed(seed, i, 0))
            return _draw(d, d.shape, gen, device).to(dtype)
        n = d.shape[0] if layers is None else min(layers, d.shape[0])
        out = torch.empty((n,) + tuple(d.shape[1:]), dtype=dtype, device=device)
        for j in range(n):
            gen.manual_seed(_slice_seed(seed, i, j))
            out[j].copy_(_draw(d, d.shape[1:], gen, device))
        return out

    return tree_map(leaf, defs)


def cast_paths(cfg, cast_leaves) -> set:
    """The paths of ``cast_leaves`` that a model holds in
    ``cfg.compute_dtype``: all but a tied embedding, which stays float32
    because the LM head reads it in float32."""
    return set(cast_leaves) - ({"embed.embedding"} if cfg.tie_embeddings else set())


def draw_cast(cfg, seed: int, defs: Tree, cast_leaves, *,
              device: "torch.device | str" = "cuda",
              layers: Optional[int] = None) -> Tree:
    """A model's ``init_on_device``: ``init_on_device`` of its tree with the
    leaves that ``load_cast`` casts drawn straight into
    ``cfg.compute_dtype`` (a config of float32 compute gives the float32
    draw)."""
    return init_on_device(seed, defs, device=device,
                          cast_leaves=cast_paths(cfg, cast_leaves),
                          compute_dtype=cfg.compute_dtype, layers=layers)


def from_jax_params(tree: Tree, defs: Optional[Tree] = None, *,
                    device: "torch.device | str" = "cuda",
                    dtype: torch.dtype = torch.float32) -> Tree:
    """A tree of numpy arrays (the JAX package's parameters, names and
    layouts unchanged) -> the same tree of tensors on ``device``, in
    ``dtype``.  A leaf that is a tensor already (``init_on_device``) keeps
    its dtype and is moved only where it lies elsewhere: no copy through
    the host.  With ``defs`` given, structure and every shape are checked
    against it."""
    device = torch.device(device)
    _check_device(device, "from_jax_params")

    def leaf(a, path):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)  # a copy

    def check(d, a, path):
        if tuple(np.shape(a)) != tuple(d.shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(a))}, "
                             f"expected {d.shape}")

    if defs is not None:
        tree_map(check, defs, tree)
    return tree_map(leaf, tree)


def load_cast(cfg, tree: Tree, defs: Tree, cast_leaves, *,
              device: "torch.device | str" = "cuda") -> Tree:
    """A model's ``load_params``: a tree of numpy arrays (``init_params`` or
    the JAX package's parameters) or of tensors (``init_on_device``) ->
    tensors on ``device`` (the card by default; raises without one),
    float32, with the leaves at the paths ``cast_leaves`` cast once to
    ``cfg.compute_dtype`` (the rounding of the reference's cast at each
    use; a leaf drawn in that dtype already is left as it is).  A tied
    embedding stays float32: the LM head reads it in float32.  TF32
    products are switched off, so that a float32 product on the card is
    exact float32, as the reference's is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cast = cast_paths(cfg, cast_leaves)
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


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis rules
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """A leaf's layout over a mesh: one entry a dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    their product, the first name outermost).  Immutable; ``tuple(spec)``
    equals ``tuple(...)`` of the JAX package's spec for the same layout."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


DEFAULT_RULES: Dict[str, Optional[str]] = {
    "embed": "data",      # FSDP / ZeRO weight sharding
    "ff": "model",        # tensor parallel
    "heads": "model",
    "kv_heads": "model",  # demoted to None when not divisible (resolve_rules)
    "vocab": "model",
    "expert": "model",    # expert parallel
    "layers": None,
    "null": None,
    "seq": None,
}


def tree_map_defs(fn: Callable[[ParamDef], Any], defs: Tree) -> Tree:
    return tree_map(lambda d, path: fn(d), defs)


def resolve_rules(mesh_axis_sizes: Dict[str, int], *, kv_heads: int = 0,
                  num_heads: int = 0, fsdp_axes: Any = "data",
                  tp_axis: Optional[str] = "model") -> Dict[str, Any]:
    """``DEFAULT_RULES`` specialised to a mesh and an arch.  ``fsdp_axes``
    may be a tuple (the whole mesh as one ZeRO axis) or None (weights
    replicated over the dp axes); ``tp_axis=None`` replicates heads, ff,
    vocab and experts; a head count that the TP axis does not divide is
    replicated."""
    rules: Dict[str, Any] = dict(DEFAULT_RULES)
    rules["embed"] = fsdp_axes
    for k in ("ff", "heads", "kv_heads", "vocab", "expert"):
        rules[k] = tp_axis
    tp = mesh_axis_sizes.get(tp_axis, 1) if tp_axis else 1
    if kv_heads and tp > 1 and kv_heads % tp != 0:
        rules["kv_heads"] = None
    if num_heads and tp > 1 and num_heads % tp != 0:
        rules["heads"] = None
    return rules


def _rule_size(rule, sizes: Dict[str, int]) -> int:
    if rule is None:
        return 1
    if isinstance(rule, tuple):
        return math.prod(sizes.get(a, 1) for a in rule)
    return sizes.get(rule, 1)


def _axes(d: ParamDef) -> Tuple[Optional[str], ...]:
    if d.axes is None:
        raise ValueError(f"ParamDef {d.shape} has no logical axes")
    return d.axes


def _leaf_pspec(d: ParamDef, rules: Dict[str, Any]) -> PartitionSpec:
    """A mesh axis shards at most one dim of a leaf: the first that asks."""
    spec, used = [], set()
    for ax in _axes(d):
        mesh_ax = rules.get(ax or "null")
        atoms = (mesh_ax if isinstance(mesh_ax, tuple)
                 else (mesh_ax,) if mesh_ax else ())
        if mesh_ax is None or used & set(atoms):
            spec.append(None)
        else:
            spec.append(mesh_ax)
            used |= set(atoms)
    return PartitionSpec(*spec)


def param_pspecs(defs: Tree, rules: Dict[str, Any]) -> Tree:
    return tree_map_defs(lambda d: _leaf_pspec(d, rules), defs)


def validate_pspecs(defs: Tree, rules: Dict[str, Any],
                    mesh_axis_sizes: Dict[str, int]) -> None:
    """Raises ``ValueError`` where a sharded dim is not divisible by the
    size of its mesh axes."""
    def check(d: ParamDef):
        for dim, ax in zip(d.shape, _leaf_pspec(d, rules)):
            n = _rule_size(ax, mesh_axis_sizes)
            if ax is not None and dim % n != 0:
                raise ValueError(
                    f"param {d.shape} axis {ax} size {dim} not divisible "
                    f"by mesh axes {ax} ({n})")
    tree_map_defs(check, defs)
