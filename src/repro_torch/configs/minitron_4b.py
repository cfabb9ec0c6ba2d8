"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679].

32L, d_model=3072, 24 Q heads / 8 KV heads (GQA), d_ff=9216 (squared-ReLU),
vocab 256000, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    norm="layernorm",
    mlp="relu2",
    rope="rope",
    rope_theta=10_000.0,
)
