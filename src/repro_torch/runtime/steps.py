"""Train, prefill and greedy decode steps: port of ``repro/runtime/steps.py``.

``kernels`` is the namespace the model's kernel calls go through:
``ops`` (the default) or ``ref.PLAIN`` for the same composition without
any kernel.  It takes the place of the reference's ``use_flash``.

The train step is the reference's ``build_train_step``: the float32
master weights cast once to the compute dtype (every float32 leaf of at
least two dimensions of the stacked tree, as the reference's ``_cast``),
the model's forward with ``remat`` (``torch.utils.checkpoint`` around each
block), the cross entropy with the vocabulary's padding masked plus the
MoE auxiliary loss, the gradients by autograd (on the card the attention
and WKV backwards are hand-written kernels), clipping by the global norm, the
schedule's rate at the optimizer's count and AdamW.  The update is written
into the parameter and moment tensors it is given (``optim.adamw``), as
the reference's launcher donates them: one pass of ``kernels.adamw_update``
a leaf, which takes the clip's factor (``optim.clip_scale``) and scales
each gradient as it reads it, so the gradients are not written.  On the
card ``runtime.capture.captured_train_step`` captures the whole step as one
CUDA graph, the port of the launcher's ``jit(train_step,
donate_argnums=(0, 1))``.

Under a mesh (``build_train_step(..., mesh=)``) the step is the per-rank
program of the reference's ``jit(train_step, in_shardings=...)``, and the
rank computes and holds only its share (``sharding.Layout``).  The
parameters and both moments are the rank's blocks under
``sharding.model_param_pspecs``, and so are the gradients autograd gives
it.  Each layer gathers its leaves over their fsdp axes where it is used
(``actshard.gathered``, inside the function ``layers.remat_call`` wraps,
so remat's recompute gathers again), and the gather's adjoint hands the
rank the sum over those axes of the ranks' gradients of its block: the
reduce-scatter.  Under '2d' and 'tp' the products are split over 'model'
(column-parallel q / k / v, MLP input and head, row-parallel attention
output and MLP output summed over 'model', the vocabulary's cross entropy
taken over 'model': ``loss_from_logits``), so a rank of 'model' runs its
heads, d_ff and vocabulary slice of the rank's rows.  Under 'cp' the
parameters are blocks over 'data' and whole over 'model', and where 'model'
divides the sequence (``sharding.Layout.seq``) a rank of 'model' holds and
computes S / cp consecutive tokens of its rows: attention gathers K and V
over 'model', a recurrence takes the state the rank before left
(``collectives.chain``), each rank's loss is its share of the mean over
every rank's tokens, and every gradient is summed over 'model' too.  Where
'model' does not divide it, its ranks hold the same tokens and nothing is
summed over 'model'.  Each rank's loss is
its share of the global mean (its rows' mean over the dp size, or its
masked sum over the mask's global count), so the sum of the ranks'
gradients is the gradient of the global loss; a leaf that no hook gathers
over a dp axis is summed over it explicitly.  The global norm for the
clip sums the blocks' squares over the mesh, a replicated leaf counted
once; AdamW runs on the blocks (the kernel on a rank's blocks).

The inference steps take a mesh too (``build_prefill_step(...,
mesh=, profile=)`` / ``build_decode_step(..., mesh=, profile=,
cache_struct=)``): each is the per-rank program of the reference
dry-run's serving jit (``repro/launch/dryrun.py``), and a rank takes and
returns exactly its device's blocks there: the parameters by
``sharding.model_param_pspecs``, the global prompt or token taken by
``sharding.batch_pspecs``, the last hidden state by P(batch, None), the
cache by ``sharding.cache_pspecs``, the token by P(batch), the logits by
P(batch, 'model') (P(batch, None) under 'fsdp').  The layout is the train
step's (weights gathered over their fsdp axes at use, heads, d_ff and
vocabulary split over 'model' under '2d' and 'tp', the expert-parallel MoE
there) plus the cache's (``sharding.Layout.set_cache``): a transformer's
KV cache split over its slots on 'model' (flash-decoding's split-S: decode
attends the rank's slots of every head and merges the partial softmaxes
by their log-sum-exp, ``attention.merge_partials``), Seamless's over its
heads, RWKV-6's state over its heads and its token shifts over d_model,
RecurrentGemma's recurrent state and convolution window over its
channels.  The greedy token is taken over the vocabulary's slices
(``greedy_token``), the same on every rank of 'model'.  Under 'cp' the
parameters are blocks over 'data' and whole over 'model', and no product
is split over 'model': a prefill's rank holds S / n positions of the
prompt (``sharding.Layout.set_batch``; the encoder-decoder's frames, its
decoder prefix whole), its attention gathers K / V and its recurrences
take the state the rank before left, as the 'cp' train step's; the cache's
blocks are ``cache_pspecs``' as under '2d' (a linear KV cache's slots are
the rank's own positions, a ring's are cut from the whole sequence's K / V
that the attention gathers), and what the sequence leaves at its end
(the last hidden state, the recurrent states, the token shifts) is the
last rank's, handed to the others (``actshard.seq_last``).  A 'cp' decode
step computes its token whole on every rank of 'model' against the
cache's blocks and returns its block of the logits.  A mesh changes no
value: every output equals the unsharded step's up to the order of
sums.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard, get_module
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw_update, clip_scale, global_norm
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import axis_index, pmax, psum, reduce_from

MOE_AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_from_logits(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                     loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy.  ``logits`` may be vocab-padded; the
    pad region is masked to -1e30 before the logsumexp.

    Under the sharded step's layout (``actshard.dp``) it is the rank's
    share of the global mean: its tokens' mean over the dp size (times the
    'model' size where 'cp' splits the sequence), or with a ``loss_mask``
    its masked sum over the mask's sum over the dp axes (and 'model'), the
    reference's global masked mean.  Where the layout splits the
    vocabulary (``actshard.split("vocab")``) ``logits`` is the rank's
    slice and the cross entropy is taken over 'model': the max over the
    axis (no gradient), the sum of exponentials over it, the gold logit
    from the rank that holds it, the padding by the global index."""
    tp = actshard.split("vocab")
    nll = (_nll(cfg, logits, labels) if tp is None
           else _vocab_parallel_nll(cfg, logits, labels, tp))
    share = actshard.dp()
    if loss_mask is not None:
        count = loss_mask.sum()
        if share is not None:
            for ax in share[1]:
                count = psum(count.detach(), share[0], ax)
        return (nll * loss_mask).sum() / torch.clamp(count, min=1.0)
    if share is not None and share[2] > 1:
        return nll.mean() / share[2]
    return nll.mean()


def _nll(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad[None, None, :], -1e30)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # [B,S]
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def _vocab_parallel_nll(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                        mesh) -> torch.Tensor:
    vl = logits.shape[-1]
    v0 = axis_index(mesh, "model") * vl
    vocab = torch.arange(v0, v0 + vl, device=logits.device)
    logits = logits.float()
    if v0 + vl > cfg.vocab_size:
        logits = logits.masked_fill((vocab >= cfg.vocab_size)[None, None, :], -1e30)
    m = pmax(logits.detach().amax(-1), mesh, "model")                  # [B,S]
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(-1), mesh, "model")
    local = labels.long() - v0
    mine = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = reduce_from(torch.where(mine, gold, torch.zeros_like(gold)), mesh, "model")
    return m + torch.log(sumexp) - gold


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def build_grad_fn(cfg: ModelConfig, *, kernels=ops, remat: bool = True,
                  ibn_chunks: int = 0, cast_params: bool = True) -> Callable:
    """(params, batch) -> (loss, {"ce", "aux"}, grads): the loss of the
    train step and its gradients with respect to every leaf of ``params``
    (float32 trees of the same structure), nothing updated.  The leaves
    need not require grad: the gradients are taken with respect to
    detached aliases of them."""
    mod = get_module(cfg)
    kw = {"ibn_chunks": ibn_chunks} if cfg.family in ("dense", "moe", "vlm") else {}

    def _cast(params):
        if not cast_params or cfg.compute_dtype == torch.float32:
            return params
        return tree_map(lambda p, path: p.to(cfg.compute_dtype)
                        if p.dtype == torch.float32 and p.dim() >= 2 else p, params)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda p, path: next(it), params)
        with torch.enable_grad():
            cast = _cast(live)
            hidden, aux = mod.forward(cfg, cast, batch, kernels=kernels,
                                      remat=remat, **kw)
            logits = mod.logits_fn(cfg, cast, hidden)
            ce = loss_from_logits(cfg, logits, batch["labels"],
                                  batch.get("loss_mask"))
            share = actshard.dp()
            if share is not None and share[2] > 1:
                aux = aux / share[2]         # the rank's share, as the ce's
            loss = ce + MOE_AUX_WEIGHT * aux
            del hidden, logits
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        return (loss.detach(), {"ce": ce.detach(), "aux": aux.detach()},
                tree_map(lambda p, path: next(it), params))

    return grad_fn


def build_train_step(
    cfg: ModelConfig,
    *,
    lr_schedule: Callable,
    clip_norm: float = 1.0,
    weight_decay: float = 0.1,
    kernels=ops,
    remat: bool = True,
    ibn_chunks: int = 0,
    cast_params: bool = True,
    mesh=None,
    profile: str = "2d",
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place (module docstring); metrics
    {"loss", "ce", "aux", "grad_norm", "lr"} as 0-d float32 tensors on the
    parameters' device.  Under a ``mesh`` the parameters and moments are
    the rank's blocks, the batch the global one, and the metrics the
    mesh's, the same on every rank (module docstring)."""
    grad_fn = build_grad_fn(cfg, kernels=kernels, remat=remat,
                            ibn_chunks=ibn_chunks, cast_params=cast_params)
    opt = dict(lr_schedule=lr_schedule, clip_norm=clip_norm,
               weight_decay=weight_decay, kernels=kernels)
    if mesh is not None:
        return _sharded_train_step(cfg, grad_fn, mesh, profile, **opt)
    return _update_step(grad_fn, global_norm, **opt)


def _update_step(grad_fn: Callable, norm_fn: Callable, *, lr_schedule: Callable,
                 clip_norm: float, weight_decay: float, kernels) -> Callable:
    """The step over ``grad_fn``'s gradients: clipping by ``norm_fn`` of
    them (their global norm), the schedule's rate at the optimizer's
    count, and AdamW through ``kernels``, which applies the clip's factor."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        gnorm = norm_fn(grads)
        lr = lr_schedule(opt_state.count)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         weight_decay=weight_decay,
                                         scale=clip_scale(gnorm, clip_norm),
                                         kernels=kernels)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def _rank_call(layout: sharding.Layout, cfg: ModelConfig, mesh, profile: str,
               batch: dict, fn: Callable, cache_struct=None):
    """``fn(the rank's block of batch)`` with ``layout`` installed
    (``actshard.set_mesh``), the batch laid out first, and the cache of
    ``cache_struct``'s shapes where given (the serving steps)."""
    layout.set_batch(sharding.batch_pspecs(cfg, mesh, batch, profile))
    if cache_struct is not None:
        layout.set_cache(sharding.cache_pspecs(cfg, mesh, cache_struct, profile))
    local = {k: sharding.local_shard(v, layout.batch_specs[k], mesh)
             for k, v in batch.items()}
    prev = actshard.current_mesh(), actshard.current_profile(), actshard.current_layout()
    actshard.set_mesh(mesh, profile, layout)
    try:
        return fn(local)
    finally:
        actshard.set_mesh(*prev)


def _sharded_train_step(cfg: ModelConfig, grad_fn: Callable, mesh, profile: str,
                        **opt) -> Callable:
    if profile not in sharding.PROFILES:
        raise ValueError(f"profile {profile!r}: one of {sharding.PROFILES}")
    layout = sharding.Layout(cfg, mesh, get_module(cfg).param_defs(cfg), profile)
    sizes = mesh.sizes

    # the dp axes a leaf's hook does not gather over (its gradient is summed
    # over them here, and over 'model' where 'cp' splits the sequence), and
    # the ranks that hold each block (its square counted once in the norm)
    unreduced = tree_map(lambda spec, path: tuple(
        a for a in layout.dp if a not in sharding.spec_axes(spec) and sizes[a] > 1),
        layout.pspecs)
    holders = tree_map(lambda spec, path: math.prod(
        n for a, n in sizes.items() if a not in sharding.spec_axes(spec)), layout.pspecs)

    def mesh_grad_fn(params, batch):
        """(the rank's blocks, the global batch) -> the mesh's (loss,
        {"ce", "aux"}), the same on every rank, and the gradients of the
        rank's blocks."""
        loss, parts, grads = _rank_call(layout, cfg, mesh, profile, batch,
                                        lambda local: grad_fn(params, local))
        seq = ("model",) if layout.seq is not None else ()

        def dp_sum(x):
            for a in layout.dp + seq:
                x = psum(x, mesh, a)
            return x

        def reduce(g, axes, path):
            for a in axes + seq:
                g = psum(g, mesh, a)
            return g

        return (dp_sum(loss), {k: dp_sum(v) for k, v in parts.items()},
                tree_map(reduce, grads, unreduced))

    def norm_fn(grads):
        def sq(g, n, path):
            s = torch.sum(torch.square(g.float()))
            return s / n if n > 1 else s
        total = sum(tree_leaves(tree_map(sq, grads, holders)))
        for a in mesh.axis_names:
            total = psum(total, mesh, a)
        return torch.sqrt(total)

    train_step = _update_step(mesh_grad_fn, norm_fn, **opt)
    train_step.pspecs, train_step.grad_fn, train_step.mesh = layout.pspecs, mesh_grad_fn, mesh
    return train_step


# ---------------------------------------------------------------------------
# Inference steps
# ---------------------------------------------------------------------------


def _serving_layout(cfg: ModelConfig, mesh, profile: str) -> sharding.Layout:
    if profile not in sharding.PROFILES:
        raise ValueError(f"profile {profile!r}: one of {sharding.PROFILES}")
    return sharding.Layout(cfg, mesh, get_module(cfg).param_defs(cfg), profile)


def prefill_cache_struct(cfg: ModelConfig, batch: dict,
                         decode_len: Optional[int] = None):
    """The shapes and dtypes of the cache that a prefill of the (global)
    ``batch`` makes, on the ``meta`` device (``launch.specs.cache_specs``
    of its rows and prompt length; the encoder-decoder's self cache
    ``decode_len`` long, its cross cache the source's length)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import cache_specs
    ref = batch["inputs_embeds"] if "inputs_embeds" in batch else batch["tokens"]
    B, S = ref.shape[0], ref.shape[1]
    if cfg.family == "audio":
        return cache_specs(cfg, ShapeConfig("prefill", "decode", decode_len or S, B),
                           src_len=S)
    return cache_specs(cfg, ShapeConfig("prefill", "decode", S, B))


def build_prefill_step(cfg: ModelConfig, *, decode_len: Optional[int] = None,
                       kernels=ops, mesh=None, profile: str = "2d") -> Callable:
    """(params, batch) -> (last_hidden [B,D], cache).  ``decode_len`` sizes
    the encoder-decoder's self-attention cache (the audio family only, as
    in the reference).

    Under a ``mesh`` (module docstring) ``params`` are the rank's blocks
    under ``sharding.model_param_pspecs``, ``batch`` the global prompt,
    and the step returns the rank's blocks of the reference's serving
    outputs: the last hidden state by P(batch, None), the cache by
    ``sharding.cache_pspecs`` of ``prefill_cache_struct``; under 'cp' the
    last hidden state is the sequence's last position's on every rank of
    'model'."""
    mod = get_module(cfg)
    kw = {"decode_len": decode_len} if cfg.family == "audio" \
        and decode_len is not None else {}

    def prefill_step(params, batch):
        return mod.prefill(cfg, params, batch, kernels=kernels, **kw)

    if mesh is None:
        return prefill_step
    layout = _serving_layout(cfg, mesh, profile)

    def sharded_prefill_step(params, batch):
        return _rank_call(layout, cfg, mesh, profile, batch,
                          lambda local: prefill_step(params, local),
                          prefill_cache_struct(cfg, batch, decode_len))

    return sharded_prefill_step


def greedy_token(cfg: ModelConfig, logits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``logits`` [B,Vp] with the padded vocabulary masked to -inf, their
    argmax [B] int32), the lowest index among equal maxima
    (``torch.argmax``'s rule, as ``jnp.argmax``'s).  Where the installed layout splits the
    vocabulary over 'model' (``actshard.split("vocab")``) ``logits`` is the
    rank's slice: the padding is masked by global index, the maxima taken
    over 'model' (``pmax``), and the token is the lowest global index among
    the ranks that hold the maximum, the same on every rank of 'model'."""
    tp = actshard.split("vocab")
    vl = logits.shape[-1]
    v0 = 0 if tp is None else axis_index(tp, "model") * vl
    if v0 + vl > cfg.vocab_size:
        pad = torch.arange(v0, v0 + vl, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad[None, :], float("-inf"))
    if tp is None:
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)
    m_local, i_local = torch.max(logits, dim=-1)
    m = pmax(m_local, tp, "model")
    cand = torch.where(m_local == m, v0 + i_local.long(),
                       torch.full_like(i_local.long(), vl * tp.sizes["model"]))
    return logits, (-pmax(-cand, tp, "model")).to(torch.int32)


def build_decode_step(cfg: ModelConfig, *, kernels=ops, mesh=None,
                      profile: str = "2d", cache_struct=None) -> Callable:
    """(params, cache, batch) -> (token [B] int32, logits [B,Vp], cache):
    greedy, with the padded vocabulary masked before the argmax.

    Under a ``mesh`` (module docstring) ``params`` and ``cache`` are the
    rank's blocks (by ``sharding.model_param_pspecs`` and by
    ``sharding.cache_pspecs`` of ``cache_struct``, the whole cache's
    shapes, as the reference's jit takes the cache's shardings: e.g.
    ``prefill_cache_struct`` of the prompt), ``batch`` the global token
    [B, 1]; the step returns the rank's blocks of the token by P(batch),
    of the logits by P(batch, 'model') (P(batch, None) under 'fsdp') and
    of the cache.  Every rank of 'model' returns the same token
    (``greedy_token``); under 'cp' each computes the whole logits and
    returns its block of the vocabulary."""
    mod = get_module(cfg)

    def decode_step(params, cache, batch):
        logits, cache = mod.decode_step(cfg, params, cache, batch,
                                        kernels=kernels)
        logits, token = greedy_token(cfg, logits)
        return token, logits, cache

    if mesh is None:
        return decode_step
    if cache_struct is None:
        raise ValueError("build_decode_step: a mesh needs the whole cache's "
                         "shapes (cache_struct), from which its blocks are laid out")
    layout = _serving_layout(cfg, mesh, profile)

    def sharded_decode_step(params, cache, batch):
        token, logits, cache = _rank_call(
            layout, cfg, mesh, profile, batch,
            lambda local: decode_step(params, cache, local), cache_struct)
        if profile == "cp":
            logits = sharding.local_shard(logits, sharding.P(None, "model"), mesh
                                          ).contiguous()
        return token, logits, cache

    return sharded_decode_step
