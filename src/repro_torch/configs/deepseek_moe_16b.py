"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed, top-6.

[arXiv:2401.06066; hf]  28L d_model=2048 16H (kv=16) expert_ff=1408
vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

config = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, expert_ff=1408),
    default_policy="q8_0",
    source="[arXiv:2401.06066; hf]",
)
