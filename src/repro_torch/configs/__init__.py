"""Configs of the port and the architecture registry.

:func:`get_config` serves the dense attention-only LMs, whose configs
are copied here from ``repro.configs``; every other architecture of the
reference (MoE, SSM, hybrid, enc-dec, VLM) raises
``NotImplementedError`` until its slice is ported.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (SD15_UNET, SD15_VAE, SD_TURBO,  # noqa: F401
                                      TINY_CLIP, TINY_SD, TINY_UNET,
                                      TINY_VAE, ModelConfig, MoEConfig,
                                      SDConfig, UNetConfig, VAEConfig,
                                      clip_config, reduced)

ARCH_MODULES = {
    "llama3-405b": "llama3_405b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-8b": "granite_8b",
    "qwen1.5-110b": "qwen1_5_110b",
}

# Architectures of the reference that need blocks this port lacks.
NOT_PORTED = ("xlstm-1.3b", "whisper-large-v3", "deepseek-moe-16b",
              "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "qwen2-vl-72b")

ARCHS = tuple(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: only the dense attention-only LMs are ported "
            f"({', '.join(ARCHS)})")
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.config


def smoke_inputs(seed: int, cfg: ModelConfig, *, batch: int = 2,
                 seq: int = 16, device="cpu") -> dict:
    """Small concrete inputs: ``tokens`` and ``labels`` of shape ``(batch,
    seq)``, drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the reference's ``smoke_inputs`` for the dense LMs; the
    audio and vision prefixes come with their slices)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=device)
            for name in ("tokens", "labels")}
