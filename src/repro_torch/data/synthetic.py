"""Deterministic, resumable synthetic data pipeline.

Every batch is a pure function of (seed, step, process_index) — a
step-indexed PRNG stream.  Fault-tolerance falls out by construction:
restoring a checkpoint at step k and asking for batch k yields exactly
the batch the failed run would have seen; elastic rescaling re-slices the
same global batch across a different process count.

The token stream is a repeating-ngram language so the loss is learnable
(per-position structure), not pure noise: token[t] depends on
token[t-1] via a fixed random permutation, with occasional resets.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """Next-token LM batches: {"tokens", "labels", "loss_mask"}."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    noise: float = 0.05          # fraction of tokens resampled uniformly

    def __post_init__(self):
        assert self.global_batch % self.process_count == 0
        self.local_batch = self.global_batch // self.process_count
        rng = np.random.default_rng(self.seed)
        # fixed bigram permutation = the "language"
        self.perm = rng.permutation(self.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.process_index)
        B, S = self.local_batch, self.seq_len
        stream = np.empty((B, S + 1), np.int64)
        stream[:, 0] = rng.integers(0, self.vocab_size, B)
        for t in range(1, S + 1):
            stream[:, t] = self.perm[stream[:, t - 1]]
        flip = rng.random((B, S + 1)) < self.noise
        stream[flip] = rng.integers(0, self.vocab_size, int(flip.sum()))
        return {
            "tokens": stream[:, :-1].astype(np.int32),
            "labels": stream[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class SyntheticSeq2SeqDataset:
    """Enc-dec batches for the audio/vlm stub frontends:
    {"inputs_embeds", "tokens", "labels"} (+"positions" for m-rope)."""

    vocab_size: int
    d_model: int
    seq_len: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    mrope: bool = False
    dtype: Any = np.float32

    def __post_init__(self):
        assert self.global_batch % self.process_count == 0
        self.local_batch = self.global_batch // self.process_count
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 89 + self.process_index)
        B, S = self.local_batch, self.seq_len
        embeds = rng.standard_normal((B, S, self.d_model)).astype(self.dtype)
        stream = np.empty((B, S + 1), np.int64)
        stream[:, 0] = rng.integers(0, self.vocab_size, B)
        for t in range(1, S + 1):
            stream[:, t] = self.perm[stream[:, t - 1]]
        out: Dict[str, np.ndarray] = {
            "inputs_embeds": embeds,
            "tokens": stream[:, :-1].astype(np.int32),
            "labels": stream[:, 1:].astype(np.int32),
        }
        if self.mrope:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                  (3, B, S)).copy()
            out["positions"] = pos
        return out


def make_dataset(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
    if cfg.family == "audio" or cfg.embedding_inputs:
        return SyntheticSeq2SeqDataset(
            vocab_size=cfg.vocab_size, d_model=cfg.d_model,
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            seed=seed, process_index=process_index,
            process_count=process_count, mrope=cfg.rope == "mrope")
    return SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        process_index=process_index, process_count=process_count)
