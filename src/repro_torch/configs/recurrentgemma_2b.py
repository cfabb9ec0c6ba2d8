"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

26L, d_model=2560, 10 heads MQA (kv=1, head_dim=256), d_ff=7680 (GeGLU),
vocab 256000.  Block pattern: (recurrent, recurrent, attention) repeated —
RG-LRU recurrence + local sliding-window attention (window 2048).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = ("recurrent", "recurrent", "attention") * 9  # 27 entries, truncated to 26

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    norm="rmsnorm",
    mlp="geglu",
    rope="rope",
    rope_theta=10_000.0,
    window=2048,
    block_pattern=_PATTERN[:26],
    lru_width=2560,
    conv1d_width=4,
)
