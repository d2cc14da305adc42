"""CLIP-style text encoder (SD v1.5 conditioning) on the LM stack."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TINY_CLIP, ModelConfig, clip_config  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_clip(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return T.init_lm(gen, cfg)


def clip_encode(params: dict, cfg: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, 77) -> hidden states (B, 77, d) (pre-unembed)."""
    s = tokens.shape[1]
    x = L.apply_embedding(params["embed"], tokens)
    x = x + T._sinusoidal(s, cfg.d_model, device=x.device)[None]
    x, _ = T._stack_fwd(params["layers"], cfg, x, causal=True)
    return T._apply_norm(cfg, params["final_norm"], x)


class CLIPTextEncoder(nn.Module):
    """``clip_encode`` over a parameter tree, as a module."""

    def __init__(self, params: dict, cfg: ModelConfig):
        super().__init__()
        self.params, self.cfg = params, cfg

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return clip_encode(self.params, self.cfg, tokens)
