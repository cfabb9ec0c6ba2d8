"""Shapes and dtypes of a train cell's inputs, allocated nowhere: port of
``repro/launch/specs.py``'s ``input_specs`` for ``kind == "train"`` (its
``ShapeDtypeStruct``s are ``TensorSpec``s here).  Its other kinds,
``cache_specs`` and ``param_specs`` serve the dry-run, ROADMAP queue 1
item 9."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """The batch dict of a train cell: full-sequence tokens and labels
    (teacher forcing); source frames and target tokens for the
    encoder-decoder; ``inputs_embeds`` where the config takes embeddings;
    M-RoPE positions.  The prefill and decode cells serve the dry-run
    (ROADMAP queue 1 item 9)."""
    if shape.kind != "train":
        raise ValueError(f"input_specs: kind {shape.kind!r}; the port takes "
                         f"'train' cells only (the dry-run's are item 9)")
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    batch: Dict[str, TensorSpec] = {}
    if cfg.family == "audio" or cfg.embedding_inputs:
        batch["inputs_embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio" or not cfg.embedding_inputs:
        batch["tokens"] = TensorSpec((B, S), tok)
    if cfg.rope == "mrope":
        batch["positions"] = TensorSpec((3, B, S), tok)
    batch["labels"] = TensorSpec((B, S), tok)
    return batch
