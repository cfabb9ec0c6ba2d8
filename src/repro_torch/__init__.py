"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same module names as the JAX package so a reader finds the counterpart:

  configs/edgenext_s.py   EdgeNeXt-S configuration (own copy)
  obs/                    tracer hooks the scheduler reports through
  core/                   the paper accelerator's cost model and
                          workloads (copies, pure Python)
  search/                 the auto-scheduler (copies) and ``lower``,
                          which emits the Hopper kernels' launch
                          parameters
  kernels/csrc/*.cu       hand-written CUDA C++ kernels for sm_90a
  kernels/{depthwise_conv,fused_ibn,flash_attention,matmul_ln}.py
                          their wrappers
  kernels/ref.py          plain PyTorch versions of the kernels
  kernels/ops.py          public entry points: CPU tensor -> plain
                          version, CUDA tensor -> kernel
  models/{params,edgenext}.py   weights and the EdgeNeXt forward pass
  serve_edgenext.py       the request loop
  edge_schedule.py        the paper end to end: cost model, search,
                          lowering, lowered kernels

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Importing it touches neither ``nvcc`` nor CUDA.
"""
