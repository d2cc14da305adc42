"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (kv=8)
d_ff=10240 vocab=32000.  SWA window 4096 (mistral-style) — the bounded
KV ring buffer is what makes long_500k feasible for this arch.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    sliding_window=4096,
    default_policy="q8_0",
    source="[arXiv:2401.16818; unverified]",
)
