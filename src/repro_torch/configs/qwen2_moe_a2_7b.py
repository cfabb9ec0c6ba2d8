"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads MHA (kv=16), MoE: 60 routed experts top-4 +
4 shared experts, d_ff_expert=1408, shared d_ff=5632, vocab 151936.

60 experts do not divide the 16-way model axis; the framework pads the routed
expert dim to 64 (pad experts receive zero routing weight — see
models/layers.py::moe_block).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    norm="rmsnorm",
    mlp="swiglu",
    rope="rope",
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        num_experts_padded=64,
        top_k=4,
        num_shared_experts=4,
        d_ff_expert=1408,
        d_ff_shared=5632,
        norm_topk_prob=False,
    ),
)
