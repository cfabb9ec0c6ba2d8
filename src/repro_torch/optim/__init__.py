"""The optimizer of the port's training path: port of ``repro.optim``
(AdamW, the learning-rate schedules, global-norm clipping; the local half
of the gradient compression is ``optim.compression``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, clip_scale, global_norm
from repro_torch.optim.schedule import constant_schedule, warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "constant_schedule", "warmup_cosine",
    "clip_by_global_norm", "clip_scale", "global_norm",
]
