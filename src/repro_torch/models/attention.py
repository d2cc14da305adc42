"""Full-sequence attention (``repro.models.attention``: ``init_attention``
and ``attention_fwd``; the KV-cache paths come with the LM slice).

CLIP uses sinusoidal positions, so no RoPE is applied on this path;
asking for it raises until the LM slice ports RoPE.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import apply_linear, init_linear
from repro_torch.kernels import ops


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    hd, hq, hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": init_linear(gen, cfg.d_model, hq * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wk": init_linear(gen, cfg.d_model, hkv * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wv": init_linear(gen, cfg.d_model, hkv * hd, role="attn_qkv",
                          bias=cfg.qkv_bias),
        "wo": init_linear(gen, hq * hd, cfg.d_model, role="attn_out"),
    }


def _split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, nheads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  causal: bool = True, kv_x: torch.Tensor | None = None,
                  rope: bool = False) -> torch.Tensor:
    """Attention over a full sequence; ``kv_x`` switches to
    cross-attention (keys/values from ``kv_x``, non-causal)."""
    if rope:
        raise NotImplementedError("RoPE is not ported yet (LM slice)")
    src = kv_x if kv_x is not None else x
    q = _split_heads(apply_linear(p["wq"], x), cfg.num_heads)
    k = _split_heads(apply_linear(p["wk"], src), cfg.num_kv_heads)
    v = _split_heads(apply_linear(p["wv"], src), cfg.num_kv_heads)
    window = cfg.sliding_window if kv_x is None else None
    out = ops.attention(q, k, v, causal=causal and kv_x is None,
                        window=window)
    return apply_linear(p["wo"], _merge_heads(out))
