"""Model configurations of the port: ``get_config(arch)`` / ``ARCHS``.

``ARCHS`` holds the LM configurations whose model is ported (RWKV-6, and
the dense and VLM transformers: ``models.transformer``); EdgeNeXt-S
(``edgenext_s``) is the vision model of the paper's path and stands
apart, as in the JAX package.  The JAX package's other architectures are
named in ``NOT_PORTED`` with the ROADMAP item that ports them;
``get_config`` raises ``KeyError`` for them and for any unknown name.
"""
from __future__ import annotations

from repro_torch.configs import (h2o_danube_1_8b, minitron_4b, olmo_1b,
                                 qwen2_vl_2b, rwkv6_1_6b, starcoder2_15b)
from repro_torch.configs.base import (ModelConfig, MoEConfig, ShapeConfig,
                                      reduced, reduced_shape)

ARCHS = {
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
}

_MOE = "ROADMAP queue 1 item 6b (MoE: layers.moe_defs / moe_apply)"
NOT_PORTED = {
    "qwen3-moe-30b-a3b": _MOE,
    "qwen2-moe-a2.7b": _MOE,
    "seamless-m4t-large-v2": ("ROADMAP queue 1 item 6b (the encoder-decoder, "
                              "models/seamless.py)"),
    "recurrentgemma-2b": "ROADMAP queue 1 item 5 (models/recurrentgemma.py)",
}


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: {NOT_PORTED[arch]}; "
                       f"ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    cfg.validate()
    return cfg


__all__ = ["ARCHS", "NOT_PORTED", "ModelConfig", "MoEConfig", "ShapeConfig",
           "get_config", "reduced", "reduced_shape"]
