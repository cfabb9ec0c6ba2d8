"""Qwen2-VL-2B backbone [arXiv:2409.12191].

28L, d_model=1536, 12 Q heads / 2 KV heads (GQA), d_ff=8960 (SwiGLU),
vocab 151936, M-RoPE (temporal/height/width sections 16/24/24 over
head_dim=128).  The vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings merged into the
token-embedding stream, plus the 3-axis M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    norm="rmsnorm",
    mlp="swiglu",
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    embedding_inputs=True,
)
