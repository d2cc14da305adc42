"""Qwen1.5-110B — dense GQA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  80L d_model=8192 64H (kv=8) d_ff=49152
vocab=152064.  QKV biases stay fp32-adjacent (GGML keeps bias adds on
the host path too).
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
    qkv_bias=True,
    default_policy="q3_k",
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)
