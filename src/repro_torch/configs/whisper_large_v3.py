"""Whisper large-v3 backbone — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356; unverified]  32L d_model=1280 20H d_ff=5120
vocab=51866.  The encoder takes precomputed 1500-frame embeddings
(``models.frontend``; the conv1d+GELU frontend is a stub).
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, head_dim=64,
    encoder_layers=32, encoder_seq=1500,
    norm="layernorm", activation="gelu", pos_embed="sinusoidal",
    default_policy="q8_0",
    source="[arXiv:2212.04356; unverified]",
)
