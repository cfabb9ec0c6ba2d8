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
the reference's launcher donates them.

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
once; AdamW runs on the blocks.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard, get_module
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw_update, clip_by_global_norm, global_norm
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
               weight_decay=weight_decay)
    if mesh is not None:
        return _sharded_train_step(cfg, grad_fn, mesh, profile, **opt)
    return _update_step(grad_fn, global_norm, **opt)


def _update_step(grad_fn: Callable, norm_fn: Callable, *, lr_schedule: Callable,
                 clip_norm: float, weight_decay: float) -> Callable:
    """The step over ``grad_fn``'s gradients: clipping by ``norm_fn`` of
    them (their global norm), the schedule's rate at the optimizer's
    count, and AdamW."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=norm_fn(grads))
        lr = lr_schedule(opt_state.count)
        params, opt_state = adamw_update(grads, opt_state, params,
                                         lr=lr, weight_decay=weight_decay)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


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
        layout.set_batch(sharding.batch_pspecs(cfg, mesh, batch, profile))
        local = {k: sharding.local_shard(v, layout.batch_specs[k], mesh)
                 for k, v in batch.items()}
        seq = ("model",) if layout.seq is not None else ()
        prev = actshard.current_mesh(), actshard.current_profile(), actshard.current_layout()
        actshard.set_mesh(mesh, profile, layout)
        try:
            loss, parts, grads = grad_fn(params, local)
        finally:
            actshard.set_mesh(*prev)

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
    train_step.pspecs, train_step.grad_fn = layout.pspecs, mesh_grad_fn
    return train_step


# ---------------------------------------------------------------------------
# Inference steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, *, decode_len: Optional[int] = None,
                       kernels=ops) -> Callable:
    """(params, batch) -> (last_hidden [B,D], cache).  ``decode_len`` sizes
    the encoder-decoder's self-attention cache (the audio family only, as
    in the reference)."""
    mod = get_module(cfg)
    kw = {"decode_len": decode_len} if cfg.family == "audio" \
        and decode_len is not None else {}

    def prefill_step(params, batch):
        return mod.prefill(cfg, params, batch, kernels=kernels, **kw)

    return prefill_step


def build_decode_step(cfg: ModelConfig, *, kernels=ops) -> Callable:
    """(params, cache, batch) -> (token [B] int32, logits [B,Vp], cache):
    greedy, with the padded vocabulary masked before the argmax."""
    mod = get_module(cfg)

    def decode_step(params, cache, batch):
        logits, cache = mod.decode_step(cfg, params, cache, batch,
                                        kernels=kernels)
        vp = logits.shape[-1]
        if vp != cfg.vocab_size:
            pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad[None, :], float("-inf"))
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        return token, logits, cache

    return decode_step
