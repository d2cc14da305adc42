"""Sampler registry: named denoise strategies (``repro.engine.samplers``).

A sampler contributes ``plan`` (per-step CPU tensors with a leading
``num_padded`` axis and a ``valid`` mask), ``init_latent``,
``model_input``, ``update`` (the solver step from
:mod:`repro_torch.diffusion.schedule`) and ``finalize``.  The engine
walks the plan with a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.diffusion import schedule as S

_REGISTRY: dict[str, "Sampler"] = {}


def register_sampler(name: str):
    def deco(cls):
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_sampler(name: str) -> "Sampler":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sampler {name!r}; registered samplers: "
                       f"{sorted(_REGISTRY)}") from None


def list_samplers() -> list[str]:
    return sorted(_REGISTRY)


class Sampler:
    """Stateless sampler strategy."""

    fixed_steps: int | None = None

    def plan(self, sched: S.NoiseSchedule, num_steps: int,
             num_padded: int) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def init_latent(self, noise: torch.Tensor,
                    plan: dict[str, torch.Tensor]) -> torch.Tensor:
        return noise

    def model_input(self, x: torch.Tensor, step: dict) -> tuple:
        return x, step["t"]

    def update(self, sched: S.NoiseSchedule, x: torch.Tensor,
               eps: torch.Tensor, step: dict) -> torch.Tensor:
        raise NotImplementedError

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _pad_plan(plan: dict[str, torch.Tensor], num_steps: int, num_padded: int,
              pad_vals: dict[str, float]) -> dict[str, torch.Tensor]:
    """Extend per-step tensors to ``num_padded`` with masked filler steps."""
    out = {"valid": torch.arange(num_padded) < num_steps}
    for k, v in plan.items():
        pad = torch.full((num_padded - num_steps,), pad_vals[k], dtype=v.dtype)
        out[k] = torch.cat([v, pad])
    return out


@register_sampler("ddim")
class DDIMSampler(Sampler):
    """Deterministic DDIM (eta=0) over evenly spaced VP timesteps."""

    def plan(self, sched, num_steps, num_padded):
        ts = S.ddim_timesteps(num_steps, sched.num_train_timesteps)
        ts = ts.to(torch.int32)
        n = int(ts.shape[0])
        ts_prev = torch.cat([ts[1:], torch.tensor([-1], dtype=torch.int32)])
        return _pad_plan({"t": ts, "t_prev": ts_prev}, n, num_padded,
                         {"t": 0, "t_prev": -1})

    def update(self, sched, x, eps, step):
        return S.ddim_step(sched, x, eps, step["t"].long(),
                           step["t_prev"].long())


@register_sampler("euler")
class EulerSampler(Sampler):
    """Euler ODE solver in the VE (sigma) view; the latent starts at
    ``noise * sqrt(1 + sigma_max^2)`` so the first model input is the
    unit noise."""

    def plan(self, sched, num_steps, num_padded):
        num_steps = max(1, min(num_steps, sched.num_train_timesteps))
        sigmas = S.euler_sigmas(sched, num_steps)
        ts = S.euler_timestep_indices(sched, num_steps)
        return _pad_plan({"t": ts, "sigma": sigmas[:-1],
                          "sigma_next": sigmas[1:]},
                         num_steps, num_padded,
                         {"t": 0, "sigma": 0.0, "sigma_next": 0.0})

    def init_latent(self, noise, plan):
        return noise * torch.sqrt(1.0 + plan["sigma"][0] ** 2)

    def model_input(self, x, step):
        return x / torch.sqrt(1.0 + step["sigma"] ** 2), step["t"]

    def update(self, sched, x, eps, step):
        return S.euler_step(x, eps, step["sigma"], step["sigma_next"])


@register_sampler("turbo")
class TurboSampler(Sampler):
    """SD-Turbo: one step from pure noise to the x0 estimate."""

    fixed_steps = 1

    def plan(self, sched, num_steps, num_padded):
        t_max = sched.num_train_timesteps - 1
        return _pad_plan({"t": torch.tensor([t_max], dtype=torch.int32)}, 1,
                         num_padded, {"t": t_max})

    def update(self, sched, x, eps, step):
        return S.turbo_step(sched, x, eps, step["t"].long())
