"""Model configurations of the port: ``get_config(arch)`` / ``ARCHS``.

``ARCHS`` holds the LM configurations of the JAX package, all ported
(RWKV-6; the dense, VLM and MoE transformers: ``models.transformer``; the
Seamless encoder-decoder: ``models.seamless``; RecurrentGemma:
``models.recurrentgemma``); EdgeNeXt-S (``edgenext_s``) is the vision
model of the paper's path and stands apart, as in the JAX package.
``NOT_PORTED`` names an architecture whose model is not ported yet with
the ROADMAP item that ports it (none is left); ``get_config`` raises
``KeyError`` for such a one and for any unknown name.
"""
from __future__ import annotations

from repro_torch.configs import (h2o_danube_1_8b, minitron_4b, olmo_1b,
                                 qwen2_moe_a2_7b, qwen2_vl_2b,
                                 qwen3_moe_30b_a3b, recurrentgemma_2b,
                                 rwkv6_1_6b, seamless_m4t_large_v2,
                                 starcoder2_15b)
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      applicable_shapes, reduced, reduced_shape)

ARCHS = {
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
}

NOT_PORTED: dict = {}


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: {NOT_PORTED[arch]}; "
                       f"ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    cfg.validate()
    return cfg


__all__ = ["ALL_SHAPES", "ARCHS", "DECODE_32K", "LONG_500K", "NOT_PORTED",
           "PREFILL_32K", "SHAPES_BY_NAME", "TRAIN_4K", "ModelConfig", "MoEConfig",
           "ShapeConfig", "applicable_shapes", "get_config", "reduced",
           "reduced_shape"]
