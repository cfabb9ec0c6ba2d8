"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 Q heads / 4 KV heads (GQA, head_dim=128), QK-norm,
MoE: 128 routed experts, top-8, d_ff_expert=768 (SwiGLU), vocab 151936.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert hidden (kept for reference; moe.d_ff_expert governs)
    vocab_size=151_936,
    norm="rmsnorm",
    mlp="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=128,
        num_experts_padded=128,
        top_k=8,
        num_shared_experts=0,
        d_ff_expert=768,
        d_ff_shared=0,
        norm_topk_prob=True,
    ),
)
