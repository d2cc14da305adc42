"""Configs of the port and the architecture registry.

:func:`get_config` serves the dense attention-only LMs, the MoE family,
whisper-large-v3 (encoder-decoder), xlstm-1.3b (mLSTM and sLSTM) and
jamba-1.5-large (Mamba and attention, MoE every second layer) and
qwen2-vl-72b (M-RoPE and a vision prefix), whose configs are copied
here from ``repro.configs``.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (SD15_UNET, SD15_VAE, SD_TURBO,  # noqa: F401
                                      TINY_CLIP, TINY_SD, TINY_UNET,
                                      TINY_VAE, ModelConfig, MoEConfig,
                                      SDConfig, UNetConfig, VAEConfig,
                                      TrainConfig, clip_config, reduced)
from repro_torch.models import frontend

ARCH_MODULES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-large-v3": "whisper_large_v3",
    "llama3-405b": "llama3_405b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-8b": "granite_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCHS = tuple(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.config


def smoke_inputs(seed: int, cfg: ModelConfig, *, batch: int = 2,
                 seq: int = 16, device="cpu") -> dict:
    """Small concrete inputs: ``tokens`` and ``labels`` of shape ``(batch,
    seq)``, for an audio config ``enc_embeds`` ``(batch, encoder_seq,
    d_model)`` bf16 and for a vision config an 8-patch ``prefix_embeds``
    ``(batch, 8, d_model)`` bf16, drawn from a ``torch.Generator`` seeded
    ``seed`` on ``device`` (the reference's ``smoke_inputs``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=device)
           for name in ("tokens", "labels")}
    if cfg.family == "audio":
        out["enc_embeds"] = frontend.synthetic_frontend(
            gen, frontend.audio_frontend_shape(cfg, batch))
    if cfg.family == "vlm":
        out["prefix_embeds"] = frontend.synthetic_frontend(
            gen, (batch, 8, cfg.d_model))
    return out
