"""OLMo-1B [arXiv:2402.00838].

16L, d_model=2048, 16 heads MHA (kv=16), d_ff=8192 (SwiGLU), vocab 50304,
non-parametric LayerNorm (no learnable scale/bias), RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    mlp="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
