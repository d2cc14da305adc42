"""Audio frontend stub (``repro.models.frontend``, the audio half).

Whisper's conv frontend is a stub: a ``TranscribeRequest`` carries the
frame embeddings it would produce, ``(encoder_seq, d_model)``.  These
helpers give that shape and a seeded synthetic stand-in.  The vision
half (qwen2-vl's patch embeddings) comes with the VLM slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def audio_frontend_shape(cfg: ModelConfig, batch: int) -> tuple:
    """Whisper conv frontend output: (B, n_frames, d_model)."""
    return (batch, cfg.encoder_seq, cfg.d_model)


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
