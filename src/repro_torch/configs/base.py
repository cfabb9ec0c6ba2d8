"""Model configurations of the port (copy of ``repro/configs/base.py``).

Every assigned architecture is expressed as a frozen ``ModelConfig``; every
assigned input shape as a ``ShapeConfig``.  Configs are plain data — models,
launchers and the dry-run all consume them.  ``reduced()`` derives the small
smoke-test variant of any config (same family, tiny dims).

Copied from the JAX package with one change: ``compute_dtype`` and
``params_dtype`` are ``torch.dtype``s.  The shape cells (``TRAIN_4K`` ...
``applicable_shapes``) are the dry-run's (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int = 0            # routed experts (as published)
    num_experts_padded: int = 0     # padded up for TP divisibility (>= num_experts)
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN hidden dim
    d_ff_shared: int = 0            # shared-expert FFN hidden dim (total)
    norm_topk_prob: bool = True

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Families:

    - ``dense``  : decoder-only transformer (TransformerLM)
    - ``moe``    : decoder-only transformer with MoE FFN (TransformerLM)
    - ``vlm``    : decoder-only transformer w/ M-RoPE + embedding inputs
    - ``hybrid`` : RG-LRU + local-attention (RecurrentGemma)
    - ``ssm``    : RWKV-6 attention-free
    - ``audio``  : encoder-decoder backbone (Seamless-M4T)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # normalization / activation flavour
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"            # swiglu | geglu | gelu | relu2
    qk_norm: bool = False

    # position encoding
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()

    # attention flavour
    window: Optional[int] = None   # sliding-window size (None = full attention)
    causal: bool = True

    # MoE
    moe: MoEConfig = MoEConfig()

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("recurrent", "recurrent", "attention")
    lru_width: int = 0
    conv1d_width: int = 4

    # ssm (RWKV-6)
    wkv_head_dim: int = 64
    wkv_chunk: int = 64

    # encoder-decoder (Seamless)
    num_encoder_layers: int = 0
    encoder_is_causal: bool = False

    # embedding / head
    tie_embeddings: bool = False
    embedding_inputs: bool = False   # model consumes [B,S,D] embeddings (vlm/audio stub)

    # compute dtypes
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # sub-quadratic? (controls long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True
        return self.window is not None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab dim always
        divides the TP axis (MaxText-style).  Logits beyond ``vocab_size``
        are masked in the loss / sampler."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.moe.enabled:
            assert self.moe.num_experts_padded >= self.moe.num_experts
        if self.family == "hybrid":
            assert self.block_pattern, "hybrid family needs a block_pattern"
        if self.rope == "mrope":
            assert sum(self.mrope_sections) * 2 == self.head_dim


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) cell.

    ``kind``:
      - ``train``   : lower ``train_step`` (fwd+bwd+optimizer)
      - ``prefill`` : lower ``prefill_step`` (fwd, builds KV cache)
      - ``decode``  : lower ``serve_step``  (1 new token, KV cache of seq_len)
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that are well-defined for this architecture.

    ``long_500k`` needs sub-quadratic attention; it is skipped for pure
    full-attention archs.
    """
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        shapes.append(LONG_500K)
    return tuple(shapes)


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    moe = cfg.moe
    if moe.enabled:
        moe = dataclasses.replace(
            moe,
            num_experts=4,
            num_experts_padded=4,
            top_k=min(moe.top_k, 2),
            num_shared_experts=min(moe.num_shared_experts, 1),
            d_ff_expert=32,
            d_ff_shared=64 if moe.d_ff_shared else 0,
        )
    n_layers = min(cfg.num_layers, 2)
    pattern = cfg.block_pattern
    if pattern:
        pattern = pattern[: max(3, n_layers)]
        n_layers = len(pattern)
    return dataclasses.replace(
        cfg,
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else None,
        moe=moe,
        block_pattern=pattern,
        lru_width=64 if cfg.lru_width else 0,
        wkv_head_dim=16,
        wkv_chunk=8,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        mrope_sections=(2, 3, 3) if cfg.rope == "mrope" else (),
        dtype="float32",
    )


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    return dataclasses.replace(
        shape,
        seq_len=min(shape.seq_len, 64),
        global_batch=min(shape.global_batch, 2),
    )
