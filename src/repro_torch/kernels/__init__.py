"""Hand-written CUDA kernels for Hopper and what surrounds them.

  fused_ibn       expand -> activation -> project with the expanded
                  intermediate kept in shared memory and registers
  flash_attention attention, the score matrix never stored: whole score
                  rows with D split over a thread-block cluster where the
                  keys fit one block, else an online softmax over KV tiles;
                  each row's log-sum-exp where a backward needs it
  flash_attention_bwd
                  its backward: dK / dV a key tile a block, dQ a query tile
                  a block, P recomputed from the log-sum-exp, no atomics
                  (``flash_attention.FlashAttention`` is the autograd
                  function around both)
  depthwise_conv  channels-last SAME depthwise convolution: halo tiles
                  staged in shared memory with zero fill, taps unrolled
                  per kernel size, the tile from ``plan``
  matmul_ln       matmul with a LayerNorm epilogue: N split over a
                  thread-block cluster, each block's slice of the rows in
                  a shared-memory line buffer, row statistics through
                  distributed shared memory before the one store
  rwkv_chunk      chunked RWKV-6 WKV recurrence in two passes: the state
                  entering every chunk (a short serial pass), then every
                  chunk at once, tile-factored products on 3xTF32 tensor
                  cores
  rwkv_chunk_bwd  its backward: a reverse states pass (the gradient of the
                  state leaving every chunk), then every chunk at once (a
                  block a chunk with its tiles resident, or a block a
                  16-row tile where that does not fit), then dlogw's
                  suffix sum and du, no atomics (``rwkv_chunk.WKVChunked`` is the autograd
                  function around both; the backward reads the forward's
                  entering states)

``ops`` holds the public entry points, ``ref`` the plain PyTorch versions
each kernel is held against.  Sources are in ``csrc/``, built by
``_build`` at first use on a CUDA tensor.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
