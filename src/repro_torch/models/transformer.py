"""The dense attention-only LM stack that CLIP uses
(``repro.models.transformer``: ``init_lm``, ``_stack_fwd``,
``_layer_fwd``, ``_block_fwd``, ``_apply_ffn``, ``_sinusoidal`` and
``_apply_norm``).

The reference stacks layer parameters over a leading period axis for
``lax.scan``; here ``params["layers"]`` is a plain list with one dict
per layer, walked by a Python loop (``weights.from_reference`` unstacks
the reference's layout).  MoE, SSM and enc-dec blocks come with later
slices.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import init_linear
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L


def _check_supported(cfg: ModelConfig) -> None:
    if set(cfg.block_pattern) != {"attn"} or cfg.moe is not None \
            or cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: only dense attention-only stacks are ported")


def _norm(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return L.init_layernorm, L.layernorm
    return L.init_rmsnorm, L.rmsnorm


def _apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    _, f = _norm(cfg)
    return f(p, x, cfg.norm_eps)


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    init_n, _ = _norm(cfg)
    p: dict[str, Any] = {"norm1": init_n(cfg.d_model, gen.device),
                         "attn": attn_mod.init_attention(gen, cfg)}
    if cfg.d_ff > 0:
        p["norm2"] = init_n(cfg.d_model, gen.device)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    init_n, _ = _norm(cfg)
    p: dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
        "final_norm": init_n(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                   role="lm_head")
    return p


def _block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
               causal: bool) -> torch.Tensor:
    h = _apply_norm(cfg, p["norm1"], x)
    return x + attn_mod.attention_fwd(p["attn"], cfg, h, causal=causal,
                                      rope=cfg.pos_embed == "rope")


def _apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """norm2 + MLP residual tail of one layer."""
    if "mlp" not in p:
        return x
    h = _apply_norm(cfg, p["norm2"], x)
    return x + L.apply_mlp(p["mlp"], h, cfg.activation)


def _layer_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
               causal: bool) -> torch.Tensor:
    return _apply_ffn(p, cfg, _block_fwd(p, cfg, x, causal=causal))


def _sinusoidal(seq: int, d: int, offset: int = 0,
                device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=device) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(torch.bfloat16)


def _stack_fwd(layers: list, cfg: ModelConfig, x: torch.Tensor, *,
               causal: bool) -> torch.Tensor:
    _check_supported(cfg)
    for p in layers:
        x = _layer_fwd(p, cfg, x, causal=causal)
    return x
