"""Inference steps of the port (``steps``) and their capture as CUDA
graphs, the port of ``jax.jit`` (``capture``)."""
from repro_torch.runtime.capture import captured, donating
from repro_torch.runtime.steps import build_decode_step, build_prefill_step

__all__ = ["build_decode_step", "build_prefill_step", "captured", "donating"]
