"""Inference steps of the port (``steps``)."""
from repro_torch.runtime.steps import build_decode_step, build_prefill_step

__all__ = ["build_decode_step", "build_prefill_step"]
