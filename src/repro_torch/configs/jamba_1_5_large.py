"""Jamba-1.5-Large (398B) — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (kv=8) d_ff=24576
vocab=65536.  Attention in 1 of every 8 layers; MoE FFN every 2nd
layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

config = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    block_pattern=("attn",) + ("mamba",) * 7,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, expert_ff=24576),
    moe_every=2,
    default_policy="q3_k",
    source="[arXiv:2403.19887; hf]",
)
