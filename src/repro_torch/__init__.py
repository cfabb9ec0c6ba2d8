"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same module names as the JAX package so a reader finds the counterpart:

  configs/edgenext_s.py   EdgeNeXt-S configuration (own copy)
  kernels/csrc/*.cu       hand-written CUDA C++ kernels for sm_90a
  kernels/{depthwise_conv,fused_ibn,flash_attention}.py   their wrappers
  kernels/ref.py          plain PyTorch versions of the kernels
  kernels/ops.py          public entry points: CPU tensor -> plain
                          version, CUDA tensor -> kernel
  models/{params,edgenext}.py   weights and the EdgeNeXt forward pass
  serve_edgenext.py       the request loop

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Importing it touches neither ``nvcc`` nor CUDA.
"""
