"""Steps of the port (``steps``: train, prefill, greedy decode), their
capture as CUDA graphs, the port of ``jax.jit`` (``capture``), the training
loop's straggler watchdog (``watchdog``), and the distributed runtime:
sharding rules (``sharding``), collectives over a mesh axis
(``collectives``), GPipe and the data-parallel fan-out (``pipeline``)."""
from repro_torch.runtime.capture import (captured, captured_train_step, donated_train_step,
                                         donating)
from repro_torch.runtime.sharding import (PROFILES, batch_pspecs, cache_pspecs,
                                          dp_axes, gather_full, local_shard,
                                          mesh_axis_sizes, model_param_pspecs)
from repro_torch.runtime.steps import (MOE_AUX_WEIGHT, build_decode_step,
                                       build_grad_fn, build_prefill_step,
                                       build_train_step, loss_from_logits)

__all__ = ["MOE_AUX_WEIGHT", "PROFILES", "batch_pspecs", "build_decode_step",
           "build_grad_fn", "build_prefill_step", "build_train_step",
           "cache_pspecs", "captured", "captured_train_step", "donated_train_step",
           "donating", "dp_axes", "gather_full", "local_shard", "loss_from_logits",
           "mesh_axis_sizes", "model_param_pspecs"]
