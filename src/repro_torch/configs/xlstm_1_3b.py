"""xLSTM-1.3B — sLSTM + mLSTM blocks at 7:1 (mLSTM:sLSTM).

[arXiv:2405.04517; unverified]  48L d_model=2048 4H d_ff=0 vocab=50304.
d_ff=0: xLSTM blocks carry their own projections; no separate FFN.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    default_policy="q8_0",
    source="[arXiv:2405.04517; unverified]",
)
