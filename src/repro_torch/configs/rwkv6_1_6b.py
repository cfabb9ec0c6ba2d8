"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892].

24L, d_model=2048, attention-free (WKV6 recurrence, 32 heads of dim 64),
channel-mix d_ff=7168 (squared-ReLU), vocab 65536, data-dependent decay.
Copy of ``repro/configs/rwkv6_1_6b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,        # wkv heads = d_model / wkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    norm="layernorm",
    mlp="relu2",
    rope="none",
    causal=True,
    wkv_head_dim=64,
    wkv_chunk=64,
)
