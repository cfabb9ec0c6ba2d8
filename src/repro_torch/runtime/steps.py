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
program of the reference's ``jit(train_step, in_shardings=...)``: the
parameters and both moments are held as each rank's block under
``sharding.model_param_pspecs``; each step gathers the whole leaves
(``sharding.gather_full``), runs forward and backward on the rank's
``batch_pspecs`` block of the global batch, takes the mean of the
gradients over the mesh (``collectives.mesh_mean``: over the dp axes the
ranks ran different rows; over the others each rank's gradient is its
share under the collectives' adjoints, and where they ran the same rows
the mean changes no value), clips by the global norm of the whole
gradients, and runs AdamW on the rank's block.  Under '2d' and 'tp' the
ranks of one 'model' coordinate run the same rows: the state is sharded
as the specs say, but the products are not split over 'model' (column /
row-parallel projections are ROADMAP queue 1 item 8a).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard, get_module
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.runtime import sharding
from repro_torch.runtime.collectives import mesh_mean

MOE_AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_from_logits(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                     loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy.  ``logits`` may be vocab-padded; the
    pad region is masked to -1e30 before the logsumexp."""
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad[None, None, :], -1e30)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # [B,S]
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if loss_mask is not None:
        nll = nll * loss_mask
        return nll.sum() / torch.clamp(loss_mask.sum(), min=1.0)
    return nll.mean()


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
    mesh's (module docstring); profile 'cp' raises
    ``NotImplementedError``."""
    grad_fn = build_grad_fn(cfg, kernels=kernels, remat=remat,
                            ibn_chunks=ibn_chunks, cast_params=cast_params)
    opt = dict(lr_schedule=lr_schedule, clip_norm=clip_norm,
               weight_decay=weight_decay)
    if mesh is not None:
        return _sharded_train_step(cfg, grad_fn, mesh, profile, **opt)
    return _update_step(grad_fn, lambda grads: grads, **opt)


def _update_step(grad_fn: Callable, to_blocks: Callable, *, lr_schedule: Callable,
                 clip_norm: float, weight_decay: float) -> Callable:
    """The step over ``grad_fn``'s whole gradients: clipping by their
    global norm, the schedule's rate at the optimizer's count, and AdamW on
    ``to_blocks`` of them (the gradients of the leaves the step holds)."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(opt_state.count)
        params, opt_state = adamw_update(to_blocks(grads), opt_state, params,
                                         lr=lr, weight_decay=weight_decay)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def _sharded_train_step(cfg: ModelConfig, grad_fn: Callable, mesh, profile: str,
                        **opt) -> Callable:
    if profile == "cp":
        raise NotImplementedError(
            "profile 'cp' shards the batch's sequence over 'model', which "
            "needs attention across sequence shards: not ported (ROADMAP "
            "queue 1 item 8b)")
    if profile not in sharding.PROFILES:
        raise ValueError(f"profile {profile!r}: one of {sharding.PROFILES}")
    pspecs = sharding.model_param_pspecs(cfg, mesh, get_module(cfg).param_defs(cfg),
                                         profile=profile)

    def mesh_grad_fn(params, batch):
        """(the rank's blocks, the global batch) -> the mesh's (loss,
        {"ce", "aux"}, whole gradients), the same on every rank."""
        bspecs = sharding.batch_pspecs(cfg, mesh, batch, profile)
        if "loss_mask" in batch and sharding.dp_size(mesh, profile) > 1:
            raise ValueError("a sharded step averages the blocks' mean losses: "
                             "a loss_mask would weigh them unequally")
        local = {k: sharding.local_shard(v, bspecs[k], mesh)
                 for k, v in batch.items()}
        full = tree_map(lambda p, spec, path: sharding.gather_full(
            p.detach(), spec, mesh), params, pspecs)
        prev = actshard.current_mesh(), actshard.current_profile()
        actshard.set_mesh(mesh, profile)
        try:
            loss, parts, grads = grad_fn(full, local)
        finally:
            actshard.set_mesh(*prev)
        del full
        return (mesh_mean(loss, mesh), {k: mesh_mean(v, mesh) for k, v in parts.items()},
                tree_map(lambda g, path: mesh_mean(g, mesh), grads))

    train_step = _update_step(
        mesh_grad_fn, lambda grads: tree_map(
            lambda g, spec, path: sharding.local_shard(g, spec, mesh), grads, pspecs),
        **opt)
    train_step.pspecs, train_step.grad_fn = pspecs, mesh_grad_fn
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
