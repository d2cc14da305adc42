"""Diffusion noise schedule and solver steps (DDIM / Euler / SD-Turbo),
as in ``repro.diffusion.schedule``.

Tensors here are float32 like the reference's.  ``_linspace`` follows
``jnp.linspace``'s formula (``start*(1-s) + stop*s``) so the schedules
agree with the reference to the last float32 bit or close to it.
"""
from __future__ import annotations

import dataclasses

import torch


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012

    def alphas_cumprod(self) -> torch.Tensor:
        betas = _linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                          self.num_train_timesteps) ** 2
        return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(num_steps: int, num_train: int = 1000) -> torch.Tensor:
    """Evenly spaced descending timesteps from ``num_train - 1``;
    ``num_steps`` is clamped to ``[1, num_train]``."""
    num_steps = max(1, min(int(num_steps), int(num_train)))
    step = num_train // num_steps
    return torch.arange(num_train - 1, -1, -step)[:num_steps]


def ddim_step(sched: NoiseSchedule, x: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    ac = sched.alphas_cumprod()
    a_t = ac[t]
    a_prev = torch.where(t_prev >= 0, ac[t_prev.clamp(min=0)],
                         torch.tensor(1.0))
    x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


def euler_timestep_indices(sched: NoiseSchedule,
                           num_steps: int) -> torch.Tensor:
    return _linspace(sched.num_train_timesteps - 1, 0,
                     num_steps).round().to(torch.int32)


def euler_sigmas(sched: NoiseSchedule, num_steps: int) -> torch.Tensor:
    ac = sched.alphas_cumprod()
    sigmas = torch.sqrt((1 - ac) / ac)
    idx = euler_timestep_indices(sched, num_steps).long()
    return torch.cat([sigmas[idx], torch.zeros((1,))])


def euler_step(x: torch.Tensor, eps: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor) -> torch.Tensor:
    return x + (sigma_next - sigma) * eps


def turbo_step(sched: NoiseSchedule, x: torch.Tensor, eps: torch.Tensor,
               t=999) -> torch.Tensor:
    """SD-Turbo: single step from pure noise to the x0 estimate."""
    a_t = sched.alphas_cumprod()[t]
    return (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
