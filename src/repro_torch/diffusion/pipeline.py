"""Single-shot text-to-image (``repro.diffusion.pipeline.generate``).

Serving workloads should use :class:`repro_torch.engine.DiffusionEngine`;
this wrapper runs the shared denoise program once at batch ``B``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.tree import to_device
from repro_torch.diffusion import schedule as sched_mod
from repro_torch.engine.api import default_sampler, uses_cfg
from repro_torch.engine.diffusion_engine import (SD_TURBO, TINY_SD,  # noqa: F401
                                                 SDConfig, build_denoise,
                                                 init_pipeline,
                                                 quantize_pipeline)
from repro_torch.engine.samplers import get_sampler


def generate(params: dict, cfg: SDConfig, tokens, seed: int | torch.Generator,
             *, steps: int | None = None, sampler: str | None = None,
             guidance_scale: float = 1.0, neg_tokens=None,
             device="cuda") -> torch.Tensor:
    """tokens: (B, 77) -> images (B, 8*latent_hw, 8*latent_hw, 3).

    Noise is a bf16 normal draw upcast to f32 (as the reference draws
    it), from ``seed``'s generator on the CPU."""
    dev = resolve_device(device)
    params = to_device(params, dev)
    steps = steps or cfg.steps
    name = sampler or default_sampler(steps)
    use_cfg = uses_cfg(neg_tokens, guidance_scale)
    tokens = torch.as_tensor(tokens, dtype=torch.long).to(dev)
    b = tokens.shape[0]
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    noise = torch.randn((b, cfg.latent_hw, cfg.latent_hw, 4), generator=gen,
                        device=gen.device)
    noise = noise.to(torch.bfloat16).float().to(dev)
    plan = get_sampler(name).plan(sched_mod.NoiseSchedule(), steps, steps)
    neg = (torch.as_tensor(neg_tokens, dtype=torch.long).to(dev)
           if neg_tokens is not None else torch.zeros_like(tokens))
    g = torch.full((b,), guidance_scale, dtype=torch.float32, device=dev)
    with torch.no_grad():
        return build_denoise(cfg, name, use_cfg)(params, tokens, neg, g,
                                                 noise, plan)
