"""Steps of the port (``steps``: train, prefill, greedy decode), their
capture as CUDA graphs, the port of ``jax.jit`` (``capture``), and the
training loop's straggler watchdog (``watchdog``)."""
from repro_torch.runtime.capture import captured, donating
from repro_torch.runtime.steps import (MOE_AUX_WEIGHT, build_decode_step,
                                       build_grad_fn, build_prefill_step,
                                       build_train_step, loss_from_logits)

__all__ = ["MOE_AUX_WEIGHT", "build_decode_step", "build_grad_fn",
           "build_prefill_step", "build_train_step", "captured", "donating",
           "loss_from_logits"]
