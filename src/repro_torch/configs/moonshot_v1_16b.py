"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64e top-6, 2 shared.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
expert_ff=1408 vocab=163840.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

config = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, expert_ff=1408),
    default_policy="q8_0",
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)
