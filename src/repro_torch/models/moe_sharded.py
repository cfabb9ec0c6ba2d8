"""Expert-parallel MoE with shard-local dispatch: port of
``repro/models/moe_sharded.py``.

The JAX module runs the layer under ``shard_map`` so that the dispatch
never crosses a device; here each rank runs that body itself:

  per data shard (the rank's tokens):
    router -> top k -> capacity scatter into a local [E, C_loc, d] buffer
    (no collective)
  per model shard (the rank's experts):
    experts e0 ... e0 + E/tp of the rank's 'model' coordinate
  combine:
    each rank's partial output for its experts' claims, plus its ff slice
    of the shared experts, then one sum over 'model'.

The auxiliary loss is taken over the rank's tokens and averaged over the
dp axes.  Over 'model' the layer is tensor-parallel (Megatron's split,
``runtime.collectives``): the routing, the aux and the shared gate are
computed whole on every rank of 'model'; the tokens, the gate values and
the shared gate enter the rank's experts through ``copy_to``, and the
partial output leaves through ``reduce_from``.  So each rank's gradient
of the router and the shared gate is the whole one, and of the experts
and the shared experts' ff slice it uses, the whole one of that block
(zero outside it where the layer is given whole leaves); over the dp axes
the aux's ``pmean`` hands each rank its share.  The layer takes either the
whole leaves (it reads the rank's experts and ff slice) or, under the
sharded train step, the rank's blocks of them.  The dispatch copies a
token's k claims by an advanced index and gathers the experts' outputs
with ``index_select``, as the plain layer does.  In the backward the
first sums each token's copies by PyTorch's sorted index backward, and
the second's repeated (clamped) index receives only exact zeros beside
the one claim it holds, so the plain layer's forward and backward repeat
bit for bit on the card (``tests/test_torch_cuda.py``); this layer's card
run waits for its sharded train step (ROADMAP item 8d).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.runtime import collectives as C

Params = Dict[str, Any]


def _local_moe(cfg: ModelConfig, capacity_factor: float, mesh,
               dp_axes: Tuple[str, ...], x: torch.Tensor, params: Params
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's body.  x: [N_loc, d], the rank's tokens; ``params`` the
    layer's whole tree, of which the rank reads its experts and its ff
    slice of the shared experts, or the rank's blocks of them.  Returns
    (out [N_loc, d] summed over 'model', aux)."""
    m = cfg.moe
    tp = mesh.sizes["model"]
    e_pad, e_real, k = m.num_experts_padded, m.num_experts, m.top_k
    n, d = x.shape
    dtype, dev = x.dtype, x.device
    e_per = e_pad // tp
    capacity = int(max(1, (k * n * capacity_factor) // e_pad))

    # routing: the same on every model shard, local to the data shard (a
    # router held as the rank's block of experts is gathered for it)
    router = params["router"]
    if router.shape[-1] != e_pad:
        router = C.gather_from(router, mesh, "model", -1)
    probs, gate_vals, expert_idx = L.moe_route(cfg, router, x)

    # aux loss over the local tokens, then averaged over dp
    me = probs[:, :e_real].mean(0)
    ce = torch.zeros(e_pad, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((n * k,), 1.0 / (n * k), dtype=torch.float32, device=dev))
    aux = e_real * torch.sum(me * ce[:e_real])
    for ax in dp_axes:
        aux = C.pmean(aux, mesh, ax)

    # the rank's experts take the replicated tokens and gate values
    x_in = C.copy_to(x, mesh, "model")
    gate_vals = C.copy_to(gate_vals, mesh, "model")

    # capacity-bounded dispatch, all local (as ``layers.moe_apply``)
    flat_e = expert_idx.reshape(-1)                               # [N*k]
    onehot_t = flat_e[None, :] == torch.arange(e_pad, device=dev)[:, None]
    pos = onehot_t.cumsum(1).gather(0, flat_e[None, :])[0] - 1
    keep = pos < capacity
    sentinel = e_pad * capacity
    slot = torch.where(keep, flat_e * capacity + pos, sentinel)
    token_idx = torch.arange(n, device=dev).repeat_interleave(k)
    buf = torch.zeros(sentinel + 1, d, dtype=dtype, device=dev).index_copy(
        0, slot, x_in[token_idx])[:sentinel].view(e_pad, capacity, d)

    # the experts of this model shard
    e0 = C.axis_index(mesh, "model") * e_per
    experts = slice(e0, e0 + e_per)
    whole = params["wi"].shape[0] == e_pad

    def mine(w):
        return (w[experts] if whole else w).to(dtype)

    buf_l = buf[experts]
    h = torch.bmm(buf_l, mine(params["wi"]))
    if "wg" in params:
        h = L.activation(cfg.mlp, torch.bmm(buf_l, mine(params["wg"]))) * h
    else:
        h = L.activation(cfg.mlp, h)
    eo_flat = torch.bmm(h, mine(params["wo"])).reshape(e_per * capacity, d)

    # combine: the partials of the claims on this shard's experts, a choice
    # at a time
    flat_e, pos, keep = flat_e.view(n, k), pos.view(n, k), keep.view(n, k)
    out = torch.zeros(n, d, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(k):
        in_shard = (flat_e[:, j] >= e0) & (flat_e[:, j] < e0 + e_per) & keep[:, j]
        local_slot = torch.where(in_shard, (flat_e[:, j] - e0) * capacity + pos[:, j],
                                 e_per * capacity - 1)
        gathered = torch.where(in_shard[:, None], eo_flat.index_select(0, local_slot),
                               zero)
        out = out + gathered * gate_vals[:, j:j + 1].to(dtype)

    # the shared experts' ff slice: its partial joins the same sum
    if "shared" in params:
        shared = params["shared"]
        f_per = m.d_ff_shared // tp
        ff = slice(C.axis_index(mesh, "model") * f_per,
                   (C.axis_index(mesh, "model") + 1) * f_per)
        cut = shared["wo"].shape[0] == m.d_ff_shared
        hs = x_in @ (shared["wi"][:, ff] if cut else shared["wi"]).to(dtype)
        if "wg" in shared:
            hs = L.activation(cfg.mlp, x_in @ (shared["wg"][:, ff] if cut
                                               else shared["wg"]).to(dtype)) * hs
        else:
            hs = L.activation(cfg.mlp, hs)
        so = hs @ (shared["wo"][ff] if cut else shared["wo"]).to(dtype)
        if "shared_gate" in params:
            sg = torch.sigmoid((x @ params["shared_gate"].to(dtype)).float())
            so = so * C.copy_to(sg, mesh, "model").to(dtype)
        out = out + so

    return C.reduce_from(out, mesh, "model"), aux


def moe_apply_sharded(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                      mesh, capacity_factor: float = 1.25
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE layer on this rank.  x: [..., N, d], the
    rank's block of the batch (its dp shard); returns (out of x's shape,
    aux averaged over the dp axes)."""
    sizes = mesh.sizes
    tp = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if cfg.moe.num_experts_padded % tp:
        raise ValueError(f"moe_apply_sharded: {cfg.moe.num_experts_padded} "
                         f"padded experts over model={tp}")
    out, aux = _local_moe(cfg, capacity_factor, mesh, dp_axes,
                          x.reshape(-1, x.shape[-1]), params)
    return out.reshape(x.shape), aux
