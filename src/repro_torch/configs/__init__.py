"""Model configurations of the port: ``get_config(arch)`` / ``ARCHS``.

``ARCHS`` holds the LM configurations whose model is ported; EdgeNeXt-S
(``edgenext_s``) is the vision model of the paper's path and stands
apart, as in the JAX package.  The JAX package's other architectures are
named in ``NOT_PORTED`` with the ROADMAP item that ports them;
``get_config`` raises ``KeyError`` for them and for any unknown name.
"""
from __future__ import annotations

from repro_torch.configs import rwkv6_1_6b
from repro_torch.configs.base import (ModelConfig, MoEConfig, ShapeConfig,
                                      reduced, reduced_shape)

ARCHS = {
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
}

_ITEM_6 = "ROADMAP queue 1 item 6 (LM layer library and attention)"
NOT_PORTED = {
    "starcoder2-15b": _ITEM_6,
    "minitron-4b": _ITEM_6,
    "h2o-danube-1.8b": _ITEM_6,
    "olmo-1b": _ITEM_6,
    "qwen3-moe-30b-a3b": _ITEM_6,
    "qwen2-moe-a2.7b": _ITEM_6,
    "qwen2-vl-2b": _ITEM_6,
    "seamless-m4t-large-v2": _ITEM_6,
    "recurrentgemma-2b": ("ROADMAP queue 1 item 5, after item 6 (its local "
                          "attention blocks need the attention library)"),
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
