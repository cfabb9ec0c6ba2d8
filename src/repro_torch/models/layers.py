"""Shared layers of the LM stack: norms, activations, the MLP (plain and
chunked), the MoE block, RoPE / M-RoPE, the GQA attention layer (self and
cross), embedding, LM head.

Port of ``repro/models/layers.py``, with the JAX names, parameter layouts
and rounding points: a norm computes in float32 and returns the input's
dtype, RoPE rotates in float32, the projections, the MLP and the experts
are products in the compute dtype (``torch.matmul`` / ``torch.bmm``, as
they are XLA's in the JAX package), the router's logits are cast to
float32 after their product, ``lm_logits`` is a float32 product with the
unembedding.  The reference's ``actshard`` anchors stand where it calls
them (each returns its input: a rank holds its block already).
``moe_apply_auto`` takes the expert-parallel MoE (``models.moe_sharded``)
under a mesh, as the reference does.

Under the sharded train step (``actshard.split``) the products are split
over 'model' as the reference's GSPMD splits them: the q / k / v
projections, the MLP's ``wi`` / ``wg`` and the head are column-parallel on
the rank's block of heads, d_ff or vocabulary (their replicated input
through ``collectives.copy_to``), ``out_project`` and the MLP's ``wo``
row-parallel (their partial output summed by ``collectives.reduce_from``),
the embedding a lookup of the rank's rows summed over 'model'.  A leaf
replicated over 'model' but used on the rank's heads (QK-norm scales, KV
heads replicated under GQA) goes through ``copy_to`` itself, so that each
rank of 'model' gets the whole gradient.  Leaves are gathered over their
fsdp axes where they are used (``actshard.gathered``).

Under 'cp' (``actshard.seq``) a rank holds S / n consecutive tokens of its
rows: ``attention_apply`` gathers K and V over 'model' and runs the
kernel on its queries at their offset, and ``moe_apply`` routes the
global batch in the reference's token order.

Under the serving steps' layout (``actshard.cache_split``) the prefill's
``attention_apply`` also returns the K / V that become the rank's cache
block, and ``attention_decode_apply`` follows the cache's split: over its
slots the new token's q / k / v are gathered over 'model', the write goes
to the rank that owns the slot, and the partial softmaxes are merged over
'model'; over its heads the rank attends locally.

Prefill attention goes
through ``kernels.flash_attention`` (``models.attention``); decode
attention is plain tensor code, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import actshard
from repro_torch.models import attention as attn_lib
from repro_torch.models.params import ParamDef

Params = Dict[str, Any]


def coll():
    """``runtime.collectives``, imported at the first use (the runtime
    package imports the models)."""
    from repro_torch.runtime import collectives
    return collectives


def norm_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    ax = ("layers",) * len(layers_dim)
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef(layers_dim + (d,), "ones", axes=ax + ("embed",))}
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef(layers_dim + (d,), "ones", axes=ax + ("embed",)),
            "bias": ParamDef(layers_dim + (d,), "zeros", axes=ax + ("embed",)),
        }
    if cfg.norm == "nonparam_ln":  # OLMo: LN without learnable params
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.square(xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * params["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """QK-norm: RMS over the head dim."""
    xf = x.float()
    var = torch.square(xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def remat_call(fn, *args, remat: bool = False):
    """``fn(*args)``; where ``remat`` and grad mode is on, under
    ``torch.utils.checkpoint`` (non-reentrant): the block's activations are
    dropped after its forward and recomputed in the backward, as the
    reference's ``jax.checkpoint`` of each scanned block.  The values are
    the same either way.  No block draws a random number, so no generator's
    state is kept for the recompute (on the card keeping it would copy the
    state: work that is not the program's)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# MLP (inverted bottleneck) — plain and chunked (C3) paths
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = (),
             d_model: Optional[int] = None,
             d_ff: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    ax = ("layers",) * len(layers_dim)
    defs: Params = {"wi": ParamDef(layers_dim + (d, f), axes=ax + ("embed", "ff")),
                    "wo": ParamDef(layers_dim + (f, d), axes=ax + ("ff", "embed"))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef(layers_dim + (d, f), axes=ax + ("embed", "ff"))
    return defs


def mlp_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
              ibn_chunks: int = 0) -> torch.Tensor:
    """FFN.  ``ibn_chunks > 1`` is the depth-first inverted-bottleneck
    schedule (contribution C3): the d_ff intermediate is produced and
    consumed one tile at a time, the output summed tile by tile in the
    compute dtype as the reference's unrolled scan sums it.  Plain products
    on every device (no LM MLP goes through ``ops.fused_ibn`` until it has
    an LM-width tiling, ROADMAP queue 2 b).  Under ``actshard.split("ff")``
    the leaves are the rank's d_ff block: ``wi`` / ``wg`` column-parallel,
    ``wo`` row-parallel, the output summed over 'model'."""
    tp = actshard.split("ff")
    if tp is not None:
        x = coll().copy_to(x, tp, "model")
        return coll().reduce_from(_mlp(cfg, params, x, ibn_chunks), tp, "model")
    return _mlp(cfg, params, x, ibn_chunks)


def _mlp(cfg: ModelConfig, params: Params, x: torch.Tensor,
         ibn_chunks: int) -> torch.Tensor:
    dtype = x.dtype
    wi, wo = params["wi"].to(dtype), params["wo"].to(dtype)
    wg = params.get("wg")
    gated = wg is not None
    if gated:
        wg = wg.to(dtype)
    if ibn_chunks <= 1:
        h = x @ wi
        h = activation(cfg.mlp, x @ wg) * h if gated else activation(cfg.mlp, h)
        return h @ wo
    f = wi.shape[-1]
    assert f % ibn_chunks == 0, (f, ibn_chunks)
    tile = f // ibn_chunks
    out = torch.zeros(x.shape[:-1] + (wo.shape[-1],), dtype=dtype,
                      device=x.device)
    for c in range(ibn_chunks):
        cols = slice(c * tile, (c + 1) * tile)
        if gated:
            t = activation(cfg.mlp, x @ wg[:, cols]) * (x @ wi[:, cols])
        else:
            t = activation(cfg.mlp, x @ wi[:, cols])
        out = out + t @ wo[cols]
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice, capacity-bounded)
# ---------------------------------------------------------------------------


def moe_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts_padded, m.d_ff_expert
    ax = ("layers",) * len(layers_dim)
    defs: Params = {"router": ParamDef(layers_dim + (d, e), axes=ax + ("embed", "expert")),
                    "wi": ParamDef(layers_dim + (e, d, f),
                                   axes=ax + ("expert", "embed", "ff")),
                    "wo": ParamDef(layers_dim + (e, f, d),
                                   axes=ax + ("expert", "ff", "embed"))}
    if cfg.mlp in ("swiglu", "geglu"):
        defs["wg"] = ParamDef(layers_dim + (e, d, f),
                              axes=ax + ("expert", "embed", "ff"))
    if m.num_shared_experts:
        defs["shared"] = mlp_defs(cfg, layers_dim, d_model=d, d_ff=m.d_ff_shared)
        defs["shared_gate"] = ParamDef(layers_dim + (d, 1), axes=ax + ("embed", None))
    return defs


def moe_apply_auto(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block as the models call it: the expert-parallel form
    (``moe_sharded.moe_apply_sharded``) where a mesh with a 'model' axis is
    installed (``actshard.set_mesh``) under the '2d' or 'tp' profile and
    the padded experts divide that axis, else the plain ``moe_apply``, as
    the reference picks."""
    mesh = actshard.current_mesh()
    if mesh is not None and "model" in mesh.axis_names \
            and actshard.current_profile() in ("2d", "tp"):
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        if cfg.moe.num_experts_padded % sizes["model"] == 0:
            from repro_torch.models import moe_sharded
            return moe_sharded.moe_apply_sharded(
                cfg, params, x, mesh=mesh, capacity_factor=capacity_factor)
    return moe_apply(cfg, params, x, capacity_factor=capacity_factor)


def moe_route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Router of ``moe_apply``: xt [N, d] -> (probs [N, E] float32, gate
    values [N, k] float32, expert indices [N, k]).  Padded experts are
    masked to ``NEG_INF`` before the softmax.  The top k come from a stable
    descending sort, so that equal probabilities go to the lower expert
    index first, as ``lax.top_k`` orders them (``torch.topk`` promises no
    order among equals)."""
    m = cfg.moe
    logits = (xt @ router.to(xt.dtype)).float()
    if m.num_experts_padded > m.num_experts:
        pad = torch.arange(m.num_experts_padded, device=xt.device) >= m.num_experts
        logits = logits.masked_fill(pad[None, :], attn_lib.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :m.top_k], idx[:, :m.top_k]
    if m.norm_topk_prob:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def _batch_split():
    """(mesh, the axes over which the sharded train step splits the batch's
    rows (those of more than one rank), ``actshard.seq()``) where it splits
    the rows or their sequence, else None."""
    layout = actshard.current_layout()
    sq = actshard.seq()
    if layout is None or not (layout.batch_axes or sq):
        return None
    return layout.mesh, layout.batch_axes, sq


def moe_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity-bounded sort-free dispatch.

    x: [..., N, d] flattened internally to [N, d].  Returns (out, aux_loss).
    Claims on an expert are taken token-major, choice-minor; a claim past
    the expert's ``capacity`` is dropped (its row of the dispatch buffer
    is a sentinel cut off after the scatter, as ``mode="drop"`` discards
    it, and its gathered output is zero).  Every step stays on the device
    and the shapes depend on N alone, so the block can be captured.

    Under the sharded train step with the rows split over ranks (the
    'fsdp' profile, or a layout that keeps the experts whole), or their
    sequence ('cp', ``actshard.seq``), the layer is the reference's GSPMD
    one over the global batch, in its flattened (row, position) token
    order: the capacity is the global batch's; a claim's place in its
    expert counts every earlier token's claims: those of every earlier
    row, and of this row's positions on the lower ranks of 'model' (each
    row's claim counts per expert all-gathered over 'model' and the rows'
    axes: under 'cp' a rank's tokens are not one run of that order); the
    aux is taken over the global batch (its mean of the router's
    probabilities summed over the ranks); each rank runs its own tokens'
    claims.  x: [..., S, d] (rows of S tokens) under a split."""
    m = cfg.moe
    orig_shape, d = x.shape, x.shape[-1]
    xt = x.reshape(-1, d)
    n, e_pad, e_real, k = xt.shape[0], m.num_experts_padded, m.num_experts, m.top_k
    dtype, dev = x.dtype, x.device

    probs, gate_vals, expert_idx = moe_route(cfg, params["router"], xt)
    flat_expert = expert_idx.reshape(-1)                          # [N*k]
    split = _batch_split()
    n_all, before = n, None
    if split is not None:           # the global batch's routing (see below)
        mesh, axes, sq = split
        C = coll()
        sums = axes + (("model",) if sq else ())
        for a in sums:
            n_all *= mesh.sizes[a]
        rows = n // x.shape[-2] if x.dim() > 2 else 1
        row_of = torch.arange(n * k, device=dev) // (n * k // rows)
        mine = torch.zeros(rows * e_pad, dtype=torch.float32, device=dev).index_add_(
            0, row_of * e_pad + flat_expert,
            torch.ones(n * k, dtype=torch.float32, device=dev)).view(rows, 1, e_pad)
        # [global rows, ranks of 'model', E]: each row's claims on each
        # rank's positions, in the global token order
        gathered = mine if not sq else C.all_gather(mine, mesh, "model", 1)
        for a in reversed(axes):
            gathered = C.all_gather(gathered, mesh, a, 0)
        me_idx = 0
        for a in axes:
            me_idx = me_idx * mesh.sizes[a] + mesh.coords[a]
        r, n_m = (sq[1], sq[2]) if sq else (0, 1)
        flat = gathered.reshape(-1, e_pad)
        earlier = torch.cumsum(flat, 0) - flat
        at = (me_idx * rows + torch.arange(rows, device=dev)) * n_m + r
        # the claims before each local row's first, less those of the
        # rank's own earlier rows (which the local cumsum counts)
        mine = mine[:, 0]
        before = earlier[at] - (torch.cumsum(mine, 0) - mine)       # [rows, E]
        counts = flat.sum(0)

    # load-balancing aux loss (Switch-style), over real experts only
    if split is None:
        me = probs[:, :e_real].mean(0)
        ce = torch.zeros(e_pad, dtype=torch.float32, device=dev).index_add_(
            0, flat_expert,
            torch.full((n * k,), 1.0 / (n * k), dtype=torch.float32, device=dev))
    else:
        me = probs[:, :e_real].sum(0)
        for a in sums:
            me = coll().psum(me, mesh, a)
        me = me / n_all
        ce = counts / (n_all * k)
    aux_loss = e_real * torch.sum(me * ce[:e_real])

    # capacity-bounded dispatch: slot = expert * C + position_in_expert
    capacity = int(max(1, (k * n_all * capacity_factor) // e_pad))
    # the reference's cumsum over the [N*k, E] one-hot, taken over its
    # transpose [E, N*k]: the same integers, but a scan along the inner
    # dimension, which the card runs in parallel (along the outer one,
    # PyTorch's scan took 1.5 ms at N*k = 8192 on the H100)
    onehot_t = flat_expert[None, :] == torch.arange(e_pad, device=dev)[:, None]
    pos_in_expert = onehot_t.cumsum(1).gather(0, flat_expert[None, :])[0] - 1
    if before is None:
        keep = pos_in_expert < capacity
    else:               # a claim's place among the global batch's claims
        keep = pos_in_expert + before.long()[row_of, flat_expert] < capacity
        capacity = min(capacity, n * k)
    sentinel = e_pad * capacity
    slot = torch.where(keep, flat_expert * capacity + pos_in_expert, sentinel)
    token_idx = torch.arange(n, device=dev).repeat_interleave(k)
    buf = torch.zeros(sentinel + 1, d, dtype=dtype, device=dev).index_copy_(
        0, slot, xt[token_idx])[:sentinel].view(e_pad, capacity, d)

    h = torch.bmm(buf, params["wi"].to(dtype))
    if "wg" in params:
        h = activation(cfg.mlp, torch.bmm(buf, params["wg"].to(dtype))) * h
    else:
        h = activation(cfg.mlp, h)
    expert_out = torch.bmm(h, params["wo"].to(dtype)).reshape(sentinel, d)

    gathered = expert_out.index_select(0, slot.clamp(max=sentinel - 1))
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=dtype,
                                                                device=dev))
    weighted = gathered * gate_vals.reshape(-1, 1).to(dtype)
    out = weighted.reshape(n, k, d).sum(1)

    if m.num_shared_experts:
        shared = mlp_apply(cfg, params["shared"], xt)
        sg = torch.sigmoid((xt @ params["shared_gate"].to(dtype)).float())
        out = out + shared * sg.to(dtype)
    return out.reshape(orig_shape), aux_loss


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: "torch.device | str" = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B,H,S,D], positions: [B,S] (int). GPT-NeoX half rotation."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                # [D/2]
    angles = positions[:, None, :, None].float() * freqs           # [B,1,S,D/2]
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): positions [3,B,S] (t/h/w streams), the head_dim/2
    frequency slots are partitioned into ``sections``, each rotated by its
    own position stream.  The slot -> stream map is built on the device (no
    copy from the host, so the step stays capturable)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    slot = torch.arange(half, device=x.device)
    sec_id = torch.zeros(half, dtype=torch.long, device=x.device)
    edge = 0
    for n in sections[:-1]:
        edge += n
        sec_id += (slot >= edge).long()
    pos_sel = positions[sec_id]                                    # [half,B,S]
    angles = pos_sel.permute(1, 2, 0).float() * freqs              # [B,S,half]
    return _rotate(x, torch.cos(angles[:, None]), torch.sin(angles[:, None]))


def image_text_positions(batch: int, seq: int, side: int,
                         device: "torch.device | str" = "cpu") -> torch.Tensor:
    """M-RoPE positions [3, batch, seq] (int32) of a prompt that opens with an
    image of side x side patches, patch i at (t, h, w) = (0, i // side,
    i % side), followed by text numbered from ``side`` on, the same on all
    three axes (one past the image's largest position), as Qwen2-VL numbers
    a text after an image: three streams that differ, where ``arange`` on
    all three makes M-RoPE RoPE."""
    i = torch.arange(seq, device=device)
    text = side + i - side * side
    image = i < side * side
    pos = torch.stack([torch.where(image, 0, text), torch.where(image, i // side, text),
                       torch.where(image, i % side, text)]).to(torch.int32)
    return pos[:, None, :].expand(3, batch, seq).contiguous()


def positional_rotate(cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


# ---------------------------------------------------------------------------
# GQA attention layer (projections + flash / decode core)
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig, layers_dim: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ax = ("layers",) * len(layers_dim)
    defs: Params = {
        "wq": ParamDef(layers_dim + (d, h, hd), axes=ax + ("embed", "heads", None)),
        "wk": ParamDef(layers_dim + (d, hk, hd), axes=ax + ("embed", "kv_heads", None)),
        "wv": ParamDef(layers_dim + (d, hk, hd), axes=ax + ("embed", "kv_heads", None)),
        "wo": ParamDef(layers_dim + (h, hd, d), axes=ax + ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(layers_dim + (hd,), "ones", axes=ax + (None,))
        defs["k_norm"] = ParamDef(layers_dim + (hd,), "ones", axes=ax + (None,))
    return defs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bhse") as one product: [B,S,d] @ [d,h*e]."""
    B, S, _ = x.shape
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).view(B, S, h, e).transpose(1, 2)


def query_project(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  positions: Optional[torch.Tensor]) -> torch.Tensor:
    """The q of ``qkv_project`` alone: [B,H,S,D]."""
    q = _heads(x, params["wq"])
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
    if positions is not None and cfg.rope != "none":
        q = positional_rotate(cfg, q, positions)
    return q


def qkv_project(cfg: ModelConfig, params: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor],
                kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None):
    """Returns q:[B,H,S,D], k,v:[B,Hkv,Skv,D] (rope applied, qk-norm
    applied); k and v are made from ``kv_x`` (cross-attention) where given."""
    kv_src = x if kv_x is None else kv_x
    kv_pos = positions if kv_positions is None else kv_positions
    q = query_project(cfg, params, x, positions)
    k, v = _heads(kv_src, params["wk"]), _heads(kv_src, params["wv"])
    if cfg.qk_norm:
        k = rms_head_norm(k, params["k_norm"])
    if positions is not None and cfg.rope != "none":
        k = positional_rotate(cfg, k, kv_pos)
    return q, k, v


def out_project(params: Params, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum("bhse,hed->bsd"): [B,H,S,D] -> [B,S,d]."""
    B, H, S, e = o.shape
    w = params["wo"].to(dtype)
    return o.transpose(1, 2).reshape(B, S, H * e) @ w.reshape(H * e, w.shape[-1])


def _kv_of_rank_heads(cfg: ModelConfig, hl: int, tp, device) -> torch.Tensor:
    """The KV head of each of the rank's ``hl`` query heads, h_global // G."""
    first = coll().axis_index(tp, "model") * hl
    return torch.div(torch.arange(first, first + hl, device=device), cfg.q_per_kv,
                     rounding_mode="floor")


def _split_heads(cfg: ModelConfig, params: Params, tp, cut_kv: bool = True) -> Params:
    """The attention leaves of a rank that computes its block of the query
    heads: a replicated QK-norm scale through ``copy_to``; replicated KV
    heads (``kv_heads`` demoted under GQA) through ``copy_to`` and, with
    ``cut_kv``, cut to the KV head of each of the rank's query heads, so
    that ``expand_kv`` is not needed."""
    C = coll()
    out = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in params:
            out[name] = C.copy_to(params[name], tp, "model")
    if actshard.split("kv_heads") is None:
        idx = _kv_of_rank_heads(cfg, params["wq"].shape[-2], tp, params["wk"].device)
        for name in ("wk", "wv"):
            out[name] = C.copy_to(params[name], tp, "model")
            if cut_kv:
                out[name] = out[name].index_select(-2, idx)
    return out


def kv_heads_split() -> bool:
    """Whether the rank computes its block of the KV heads (the heads split
    over 'model' and the KV heads with them), not all of them."""
    return actshard.split("heads") is not None and actshard.split("kv_heads") is not None


def expand_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """GQA: each KV head repeated for its ``q_per_kv`` query heads, so that
    query head h reads KV head h // G (``jnp.repeat(k, G, axis=1)``)."""
    G = cfg.q_per_kv
    if G > 1:
        return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return k, v


def attention_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    causal: Optional[bool] = None,
                    window: Optional[int] = None, kernels=ops,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    kv_entry: Optional[str] = None, return_kv: bool = False):
    """Full-sequence attention (train / prefill); cross-attention into
    ``kv_x`` where given.  Under ``actshard.split("heads")`` the rank
    computes its block of the heads (column-parallel q / k / v, the kernel
    on H/tp heads, row-parallel ``out_project`` summed over 'model').
    ``return_kv`` (a prefill's cache): returns (out, k, v), k and v
    [B,Hkv',S,D] before the GQA expansion, the rank's KV heads where it
    computes its block of them (``kv_heads_split``), else all of them
    (replicated KV heads projected whole and cut to the rank's query heads
    for the kernel only).

    Under ``actshard.seq(kv_entry)`` (the batch entry whose sequence the
    keys come from: the rows' by default, or the encoder's frames) the
    rank holds S / n consecutive positions of the keys' sequence (RoPE
    already at them): k and v are gathered over 'model' before the GQA
    expansion (the wire carries the KV heads), the gather's adjoint handing
    each rank the sum of dK / dV of its block.  Causal attention (self-attention, whose
    queries are the rank's block of the same sequence) keeps the first
    (r + 1) S / n keys and runs the kernel at ``q_offset`` r S / n, so that
    the window holds across the shard's edge; non-causal attention takes
    every key at offset 0.  ``return_kv`` returns the gathered sequence's K
    and V, of which ``actshard.to_cache`` keeps the rank's block."""
    causal_ = cfg.causal if causal is None else causal
    window_ = cfg.window if window is None else window
    tp = actshard.split("heads")
    if tp is not None:
        C = coll()
        x = C.copy_to(x, tp, "model")
        kv_x = None if kv_x is None else C.copy_to(kv_x, tp, "model")
        params = _split_heads(cfg, params, tp, cut_kv=not return_kv)
    q, k, v = qkv_project(cfg, params, x, positions, kv_x=kv_x,
                          kv_positions=kv_positions)
    kv = (k, v)
    if tp is not None and return_kv and actshard.split("kv_heads") is None:
        idx = _kv_of_rank_heads(cfg, q.shape[1], tp, q.device)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    offset = 0
    sq = actshard.seq(kv_entry)
    if sq is not None:
        mesh, r, _ = sq
        S = k.shape[2]
        k, v = torch.unbind(coll().all_gather(torch.stack([k, v]), mesh, "model", 3))
        kv = (k, v)
        if causal_:
            offset = r * S
            k, v = k[:, :, :offset + S], v[:, :, :offset + S]
    if k.shape[1] != q.shape[1]:
        k, v = expand_kv(cfg, k, v)
    o = attn_lib.flash_attention(q, k, v, causal_, window_, kernels=kernels,
                                 q_offset=offset)
    o = actshard.attn_out_sharded(o)
    out = out_project(params, o, x.dtype)
    if tp is not None:
        out = coll().reduce_from(out, tp, "model")
    out = actshard.batch_sharded(out)
    return (out, *kv) if return_kv else out


def attention_decode_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
                           position: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_index: torch.Tensor,
                           window: Optional[int] = None, *, field: str = "k"):
    """Single-token decode.  x: [B,1,d].  cache_k/v: [B,Hkv,S,D].

    Returns (out [B,1,d], new_cache_k, new_cache_v).  ``cache_index`` is the
    absolute decode step, a 0-d integer tensor on the device (as are the
    write index, ``valid`` and the RoPE position, so that the step can be
    captured); ring addressing is used iff window is not None.  The write
    index is clamped to S - 1, as ``lax.dynamic_update_slice_in_dim``
    clamps it: past a linear cache of the prompt's length every step
    overwrites its last slot, as the reference's does.

    Under a serving layout the cache leaf is the rank's block of the cache
    ``field`` (``actshard.cache_split``), and q / k / v are column-parallel
    on the rank's heads under ``actshard.split("heads")`` (the KV heads
    projected whole where they are replicated); the new token's k / v are
    gathered over 'model' on the heads wherever the cache holds every KV
    head; where the cache holds the rank's KV heads and the rank computes
    every head ('cp'), the new token's k / v are cut to them.  Where 'model'
    splits the cache's slots (flash-decoding's split-S:
    the rank holds slots r S/n ... (r + 1) S/n - 1 of every KV head) the
    write goes to the rank that owns the global write index, decided on the
    device (the others write back what the slot held), and ``attend_cache``
    merges the ranks' partial softmaxes.  ``out_project`` is row-parallel on
    the rank's heads, summed over 'model' (``reduce_from``); without
    ``tp`` it takes every head.
    """
    B = x.shape[0]
    if cfg.rope == "mrope":
        # text-token M-RoPE: all three streams advance with the step
        positions = position.reshape(1, 1, 1).expand(3, B, 1)
    else:
        positions = position.reshape(1, 1).expand(B, 1)
    C = coll()
    tp, cs = actshard.split("heads"), actshard.cache_split(field)
    if tp is not None:
        x = C.copy_to(x, tp, "model")
    q, k, v = qkv_project(cfg, params, x, positions)
    by_slots = cs is not None and cs[1] == 2
    by_heads = cs is not None and cs[1] == 1
    if by_heads and tp is None:                    # 'cp': q / k / v on every head
        hk = cache_k.shape[1]
        k, v = k.narrow(1, cs[2] * hk, hk), v.narrow(1, cs[2] * hk, hk)
    elif by_heads and not kv_heads_split():
        raise ValueError("attention_decode_apply: the cache holds the rank's KV "
                         "heads but the rank does not compute its block of them")
    if not by_heads and kv_heads_split():          # the cache holds every KV head
        k, v = torch.unbind(C.gather_from(torch.stack([k, v]), tp, "model", 2))
    S_block = cache_k.shape[2]
    S = S_block * cs[3] if by_slots else S_block
    write_idx = cache_index % S if window is not None else cache_index
    write_idx = torch.clamp(write_idx, max=S - 1)
    k, v = k.to(cache_k.dtype), v.to(cache_v.dtype)
    if by_slots:
        local = write_idx - cs[2] * S_block
        mine = (local >= 0) & (local < S_block)
        idx = torch.clamp(local, 0, S_block - 1).long().reshape(1)
        k = torch.where(mine, k, cache_k.index_select(2, idx))
        v = torch.where(mine, v, cache_v.index_select(2, idx))
    else:
        idx = write_idx.long().reshape(1)
    cache_k = cache_k.index_copy(2, idx, k)
    cache_v = cache_v.index_copy(2, idx, v)
    valid = torch.clamp(cache_index + 1, max=S)
    o = attend_cache(cfg, q, cache_k, cache_v, valid, tp, cs)
    out = out_project(params, o, x.dtype)
    if tp is not None:
        out = C.reduce_from(out, tp, "model")
    return out, cache_k, cache_v


def attend_cache(cfg: ModelConfig, q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, valid, tp, cs) -> torch.Tensor:
    """One token's attention [B,Hq',1,D] of q [B,Hq',1,D] (the rank's query
    heads under ``tp``, else all) against a cache block laid out by ``cs``
    (``actshard.cache_split``), ``valid`` slots of the whole cache valid:
    over its slots, q of every head gathered over 'model', the rank's
    ``decode_attention_partial`` merged with the others'
    (``merge_partials``) and the rank's heads of o kept; over its KV heads,
    the rank's heads attended locally, and where q holds every head ('cp':
    no ``tp``) the query heads of the rank's KV heads, their o gathered
    over 'model' on the heads; whole, the rank's heads against it, read at
    the KV head of each of them; ``decode_attention`` with neither a split
    nor ``tp``."""
    C = coll()
    if cs is not None and cs[1] == 1 and tp is None:        # heads over 'model'
        mesh, _, r, n = cs
        hq = q.shape[1] // n
        o = attn_lib.decode_attention(q.narrow(1, r * hq, hq), cache_k, cache_v, valid)
        return C.gather_from(o, mesh, "model", 1)
    if cs is not None and cs[1] == 2:                       # slots over 'model'
        mesh, _, r, _ = cs
        hl = q.shape[1]
        if tp is not None:
            q = C.gather_from(q, tp, "model", 1)
        S_block = cache_k.shape[2]
        slots = r * S_block + torch.arange(S_block, device=q.device)
        part = attn_lib.decode_attention_partial(q, cache_k, cache_v, slots, valid)
        o = attn_lib.merge_partials([part], mesh, "model").to(q.dtype)
        return o if tp is None else o.narrow(1, r * hl, hl)
    if tp is not None and (cs is None or cs[1] != 1):       # the whole cache
        if actshard.split("kv_heads") is not None:
            hk = cache_k.shape[1] // tp.sizes["model"]
            r = C.axis_index(tp, "model")
            cache_k, cache_v = (c.narrow(1, r * hk, hk) for c in (cache_k, cache_v))
        else:
            idx = _kv_of_rank_heads(cfg, q.shape[1], tp, q.device)
            cache_k, cache_v = (c.index_select(1, idx) for c in (cache_k, cache_v))
    return attn_lib.decode_attention(q, cache_k, cache_v, valid)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_defs(cfg: ModelConfig) -> Params:
    v = cfg.padded_vocab
    defs: Params = {"embedding": ParamDef((v, cfg.d_model), "embed", scale=1.0,
                                          axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, v), axes=("embed", "vocab"))
    return defs


def embed_tokens(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens: [B, S] integer -> [B, S, D] in ``dtype``.  ``F.embedding``,
    whose backward on the card sums a repeated token's rows in a fixed
    order (``index_select``'s accumulates them by atomics, so that two
    equal train steps could differ in the embedding's gradient bits).
    Under ``actshard.split("vocab")`` the rank holds rows v0 ... v0 + V/tp
    of the table: it looks up the tokens among them, zeros the others, and
    the rows are summed over 'model' (each token is found on one rank)."""
    w = actshard.gathered(params["embedding"], "embed.embedding")
    tp = actshard.split("vocab")
    if tp is None:
        return F.embedding(tokens, w).to(dtype)
    C = coll()
    rows = w.shape[0]
    local = tokens.long() - C.axis_index(tp, "model") * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), w)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return C.reduce_from(x, tp, "model").to(dtype)


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B, S, padded vocab], a float32 product (exact float32
    on the card as long as TF32 matmul is off, which the models set).
    Under ``actshard.split("vocab")``: the rank's [B, S, V/tp] slice,
    column-parallel (``runtime.steps.loss_from_logits`` takes the cross
    entropy over 'model')."""
    if "unembed" in params:
        w = actshard.gathered(params["unembed"], "embed.unembed")
    else:
        w = actshard.gathered(params["embedding"], "embed.embedding").T
    tp = actshard.split("vocab")
    if tp is not None:
        x = coll().copy_to(x, tp, "model")
    return torch.matmul(x.float(), w.float())
