"""Models of the port: EdgeNeXt (``edgenext``), RWKV-6 (``rwkv6``), their
parameter trees (``params``) and shared LM layers (``layers``).

``get_module(cfg)`` dispatches an LM configuration's family to its module,
as the JAX package's ``repro.models.get_module`` does; a family that is
not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

NOT_PORTED = {
    "dense": "ROADMAP queue 1 item 6 (models/transformer.py)",
    "moe": "ROADMAP queue 1 item 6 (models/transformer.py)",
    "vlm": "ROADMAP queue 1 item 6 (models/transformer.py)",
    "audio": "ROADMAP queue 1 item 6 (models/seamless.py)",
    "hybrid": "ROADMAP queue 1 item 5, after item 6 (models/recurrentgemma.py)",
}


def get_module(cfg):
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not "
                                  f"ported yet: {NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
