"""H2O-Danube-1.8B [arXiv:2401.16818].

Llama+Mistral mix: 24L, d_model=2560, 32 Q heads / 8 KV heads (GQA),
d_ff=6912 (SwiGLU), vocab 32000, RMSNorm, sliding-window attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    norm="rmsnorm",
    mlp="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    window=4096,
)
