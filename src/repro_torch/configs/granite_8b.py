"""Granite-8B (code) — llama-arch dense GQA.

[arXiv:2405.04324; hf]  36L d_model=4096 32H (kv=8) d_ff=14336
vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49152, head_dim=128,
    default_policy="q8_0",
    source="[arXiv:2405.04324; hf]",
)
