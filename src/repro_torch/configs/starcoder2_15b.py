"""StarCoder2-15B [arXiv:2402.19173].

40L, d_model=6144, 48 Q heads / 4 KV heads (GQA), d_ff=24576 (4x, gelu),
vocab 49152, RoPE, LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    mlp="gelu",
    rope="rope",
    rope_theta=100_000.0,
)
