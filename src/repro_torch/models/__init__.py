"""Models of the port: EdgeNeXt (``edgenext``), RWKV-6 (``rwkv6``), the
dense, VLM and MoE transformer (``transformer``), the Seamless
encoder-decoder (``seamless``) and the RecurrentGemma hybrid
(``recurrentgemma``) over the attention library (``attention``), their
parameter trees (``params``) and shared LM layers (``layers``).

``get_module(cfg)`` dispatches an LM configuration's family to its module,
as the JAX package's ``repro.models.get_module`` does; a family in
``NOT_PORTED`` (none is left) raises ``NotImplementedError`` naming its
ROADMAP item.
"""
from __future__ import annotations

NOT_PORTED: dict = {}


def get_module(cfg):
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family in ("dense", "vlm", "moe"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "audio":
        from repro_torch.models import seamless
        return seamless
    if cfg.family == "hybrid":
        from repro_torch.models import recurrentgemma
        return recurrentgemma
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not "
                                  f"ported yet: {NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
