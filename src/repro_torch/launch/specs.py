"""Shapes and dtypes of a cell's parameters, inputs and decode cache,
allocated nowhere: port of ``repro/launch/specs.py`` (its
``ShapeDtypeStruct``s are ``TensorSpec``s here).  The sharded serving
steps lay the cache out by ``cache_specs``
(``runtime.steps.prefill_cache_struct``); the dry-run (``launch.dryrun``)
makes a rank's blocks of all three on the meta device."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import opcount
from repro_torch.models import get_module
from repro_torch.models.params import tree_map_defs


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """The batch dict for one (arch x shape) cell.

    train   : full-sequence tokens and labels (teacher forcing); source
              frames and target tokens for the encoder-decoder;
              ``inputs_embeds`` where the config takes embeddings
    prefill : the prompt batch (the encoder-decoder's frames and its
              one-token decoder prefix)
    decode  : one new token a sequence (the cache is a separate argument:
              ``cache_specs``)
    M-RoPE positions [3, B, S] with train and prefill batches."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    kind = shape.kind
    if kind == "decode":
        return {"tokens": TensorSpec((B, 1), tok)}
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    batch: Dict[str, TensorSpec] = {}
    if cfg.family == "audio" or cfg.embedding_inputs:
        batch["inputs_embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        batch["tokens"] = TensorSpec((B, S if kind == "train" else 1), tok)
    elif not cfg.embedding_inputs:
        batch["tokens"] = TensorSpec((B, S), tok)
    if cfg.rope == "mrope":
        batch["positions"] = TensorSpec((3, B, S), tok)
    if kind == "train":
        batch["labels"] = TensorSpec((B, S), tok)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                src_len: Optional[int] = None) -> Any:
    """The decode cache of a cell, each leaf a ``TensorSpec``: the family's
    ``init_cache`` for the shape's batch and sequence on the ``meta``
    device (no allocation, and no count of a ``core.opcount.OpCounter``
    around it).  ``src_len``: the encoder-decoder's cross cache
    length where it is not the sequence's (a prefill's source)."""
    mod = get_module(cfg)
    B, S = shape.global_batch, shape.seq_len
    kw = {"src_len": src_len} if src_len is not None else {}
    with opcount.ignored():
        cache = mod.init_cache(cfg, B, S, device="meta", **kw)

    def spec(x):
        if isinstance(x, list):
            return [spec(t) for t in x]
        return TensorSpec(tuple(x.shape), x.dtype)

    return type(cache)(**{f: spec(getattr(cache, f)) for f in cache._fields})


def param_specs(cfg: ModelConfig, *, serve_bf16: bool = False) -> Any:
    """The parameters' shapes and dtypes, a ``TensorSpec`` a leaf of the
    family's ``param_defs`` tree (float32, as every leaf is made).
    ``serve_bf16``: matrices held in bf16, the serving layout (weights are
    read every decode step; bf16 halves the dominant HBM term); vectors and
    scalars stay float32."""
    defs = get_module(cfg).param_defs(cfg)
    return tree_map_defs(lambda d: TensorSpec(
        tuple(d.shape), torch.bfloat16 if serve_bf16 and len(d.shape) >= 2
        else torch.float32), defs)
