"""Qwen2-VL-72B backbone — M-RoPE, dynamic resolution (frontend STUB).

[arXiv:2409.12191; hf]  80L d_model=8192 64H (kv=8) d_ff=29568
vocab=152064.  M-RoPE sections (16, 24, 24) over head_dim/2 = 64;
vision patch embeddings arrive precomputed as ``prefix_embeds``.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    mrope=True, mrope_sections=(16, 24, 24),
    default_policy="q8_0",
    source="[arXiv:2409.12191; hf]",
)
