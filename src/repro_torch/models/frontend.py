"""Modality frontend stubs (``repro.models.frontend``).

Whisper's conv frontend and qwen2-vl's patch merger are stubs: a
``TranscribeRequest`` carries the frame embeddings the first would
produce, ``(encoder_seq, d_model)``, and a vision prompt the patch
embeddings of the second, ``(VLM_PATCHES, d_model)`` per row, which
``lm_forward(prefix_embeds=...)`` prepends to the text.  These helpers
give those shapes and a seeded synthetic stand-in.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

VLM_PATCHES = 256  # stub: one low-res image worth of patch embeddings


def audio_frontend_shape(cfg: ModelConfig, batch: int) -> tuple:
    """Whisper conv frontend output: (B, n_frames, d_model)."""
    return (batch, cfg.encoder_seq, cfg.d_model)


def vision_frontend_shape(cfg: ModelConfig, batch: int) -> tuple:
    """Qwen2-VL patch-merger output: (B, n_patches, d_model)."""
    return (batch, VLM_PATCHES, cfg.d_model)


def synthetic_frontend(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Normal frame embeddings times 0.02, bf16, drawn from ``gen`` on
    its device."""
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.to(torch.bfloat16) * 0.02


def synthetic_audio(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    """One request's synthetic audio-frame embeddings, ``(encoder_seq,
    d_model)``: the tensor a ``TranscribeRequest`` carries (unbatched:
    the ASR engine streams it per slot)."""
    return synthetic_frontend(gen, audio_frontend_shape(cfg, 1))[0]
