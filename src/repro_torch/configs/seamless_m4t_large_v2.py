"""Seamless-M4T-large-v2 backbone [arXiv:2308.11596].

Encoder-decoder: 24L encoder + 24L decoder, d_model=1024, 16 heads MHA,
d_ff=8192, vocab 256206.  The speech/text modality frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings for the
encoder; the decoder consumes token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,            # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    norm="layernorm",
    mlp="gelu",
    rope="none",              # learned/sinusoidal positions in the original;
                              # backbone uses relative ids via rope=none + pos-emb
    embedding_inputs=True,    # encoder takes [B,T,D] frames (frontend stubbed)
)
