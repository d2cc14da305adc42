"""Request-based text-to-image engine (CLIP -> UNet loop -> VAE).

The counterpart of ``repro.engine.diffusion_engine``'s fused path:

* ``build_denoise`` returns ``fn(params, tokens, neg_tokens, gscale,
  noise, plan)``; its denoise loop is a Python loop over the sampler's
  step plan where the reference has one ``lax.scan``.  Padding steps
  (``valid`` False) are skipped: the reference masks them with
  ``jnp.where``, so the result is the same and no UNet runs for them.
* ``DiffusionEngine`` keeps the reference's host plumbing: ``submit`` /
  ``step`` / ``run`` / ``cancel`` of queued requests, earliest-deadline-
  first pop, batch buckets padded with row 0, ``weight_quant=``, and
  ``Admitted``/``Finished``/``Cancelled`` events on its ``EventBus``.
* Initial noise comes from ``noise_fn(request, hw)``; the default draws
  ``torch.randn`` from a generator seeded with the request's seed.  It
  cannot reproduce ``jax.random``, so tests inject the reference's noise.

Not ported yet: the segmented preview path (``preview_every``), the cost
model and telemetry, ``evacuate``/``adopt`` and ``EngineConfig``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SD_TURBO, TINY_SD, SDConfig  # noqa: F401
from repro_torch.core.policy import OffloadPolicy, get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.tree import to_device
from repro_torch.diffusion import schedule as sched_mod
from repro_torch.engine import events as ev
from repro_torch.engine import samplers as samplers_mod
from repro_torch.engine.api import GenerateRequest, GenerateResult, uses_cfg
from repro_torch.models import clip as clip_mod
from repro_torch.models import unet as unet_mod
from repro_torch.models import vae as vae_mod


def init_pipeline(seed: int | torch.Generator, cfg: SDConfig, *,
                  device="cuda") -> dict:
    """Synthetic weights for CLIP, UNet and VAE, drawn from one seeded
    ``torch.Generator`` on ``device`` (or from the generator given)."""
    dev = resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(seed)))
    params = {
        "clip": clip_mod.init_clip(gen, cfg.clip_cfg()),
        "unet": unet_mod.init_unet(gen, cfg.unet),
        "vae": vae_mod.init_vae_decoder(gen, cfg.vae),
    }
    return to_device(params, dev)


def quantize_pipeline(params: dict, policy: OffloadPolicy) -> dict:
    """GGML-style model-file quantization (the paper's two models)."""
    return quantize_params(params, policy)


def steps_bucket(steps: int) -> int:
    """Round a step count up to the next power of two (the reference's
    compile-cache bucket; here padded steps are skipped, not run)."""
    b = 1
    while b < steps:
        b *= 2
    return b


def build_denoise(cfg: SDConfig, sampler_name: str, use_cfg: bool, *,
                  decode: bool = True) -> Callable:
    """``fn(params, tokens, neg_tokens, gscale, noise, plan)``: ``(B,
    text_len)`` prompts and ``(B, hw, hw, 4)`` unit noise to images (or x0
    latents with ``decode=False``)."""
    sampler = samplers_mod.get_sampler(sampler_name)
    sched = sched_mod.NoiseSchedule()
    clip_cfg = cfg.clip_cfg()

    def fn(params, tokens, neg_tokens, gscale, noise, plan):
        b = tokens.shape[0]
        ctx = clip_mod.clip_encode(params["clip"], clip_cfg, tokens)
        ctx_u = (clip_mod.clip_encode(params["clip"], clip_cfg, neg_tokens)
                 if use_cfg else None)
        x = sampler.init_latent(noise.float(), plan)
        g = gscale[:, None, None, None]
        for i in range(plan["valid"].shape[0]):
            step = {k: v[i] for k, v in plan.items()}
            if not bool(step["valid"]):
                continue
            xm, t = sampler.model_input(x, step)
            tb = t.to(device=x.device, dtype=torch.int32).expand(b)
            xb = xm.to(torch.bfloat16)
            eps = unet_mod.apply_unet(params["unet"], cfg.unet, xb, tb,
                                      ctx).float()
            if use_cfg:
                eps_u = unet_mod.apply_unet(params["unet"], cfg.unet, xb, tb,
                                            ctx_u).float()
                eps = eps_u + g * (eps - eps_u)
            x = sampler.update(sched, x, eps, step)
        x0 = sampler.finalize(x)
        if not decode:
            return x0
        return vae_mod.apply_vae_decoder(params["vae"], cfg.vae,
                                         x0.to(torch.bfloat16))
    return fn


def request_noise(req: GenerateRequest, hw: int) -> torch.Tensor:
    """Unit-normal initial latent for one request, from its seed only."""
    gen = torch.Generator().manual_seed(int(req.seed))
    return torch.randn((hw, hw, 4), generator=gen, dtype=torch.float32)


class DiffusionEngine(ev.EventStreamMixin):
    """Micro-batching diffusion engine (implements the Engine protocol).

    ``step()`` pops up to ``max_batch`` queued requests that share a
    group — same (sampler, steps, latent size, guidance mode) — seeded
    earliest-deadline-first, pads them to the batch bucket with row 0,
    runs the denoise program on ``device`` and retires the batch.
    """

    def __init__(self, params: dict, cfg: SDConfig, *, max_batch: int = 1,
                 bus: ev.EventBus | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 weight_quant: str | None = None, device="cuda",
                 noise_fn: Callable[[GenerateRequest, int],
                                    torch.Tensor] | None = None):
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        if weight_quant is not None:
            params = quantize_pipeline(params, get_policy(weight_quant))
        self.weight_quant = weight_quant
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.noise_fn = noise_fn or request_noise
        self.queue: deque[GenerateRequest] = deque()
        self.finished: list[GenerateResult] = []
        self.bus = bus if bus is not None else ev.EventBus(clock)
        self._meta: dict[int, tuple] = {}       # rid -> (seq, deadline, prio)
        self._subseq = 0

    # ------------------------------------------------------------ API
    def submit(self, request: GenerateRequest) -> ev.RequestHandle:
        samplers_mod.get_sampler(request.sampler)   # fail fast on typos
        if request.steps < 1:
            raise ValueError(f"steps must be >= 1, got {request.steps}")
        if request.preview_every < 0:
            raise ValueError(
                f"preview_every must be >= 0, got {request.preview_every}")
        if request.preview_every:
            raise NotImplementedError(
                "preview_every > 0 needs the segmented preview path, which "
                "is not ported yet")
        hw = (self.cfg.latent_hw if request.latent_hw is None
              else request.latent_hw)
        down = 2 ** (len(self.cfg.unet.channel_mult) - 1)
        if hw < down or hw % down:
            raise ValueError(
                f"latent_hw={hw} must be a positive multiple of the "
                f"UNet downsample factor {down}")
        if request.rid in self._meta \
                or self.bus.terminal(request.rid) is not None:
            raise ValueError(f"duplicate rid {request.rid}")
        deadline = (float("inf") if request.deadline_ms is None
                    else self.bus.clock() + request.deadline_ms / 1e3)
        request._deadline = deadline
        self._meta[request.rid] = (self._subseq, deadline, request.priority)
        self._subseq += 1
        self.queue.append(request)
        return self.handle(request.rid)

    def has_work(self) -> bool:
        return bool(self.queue)

    def cancel(self, rid: int) -> bool:
        """Abort a queued request.  A running batch retires atomically."""
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                self.bus.emit(ev.Cancelled, rid)
                return True
        return False

    def step(self) -> int:
        """Pop and run one micro-batch; returns #requests progressed."""
        if not self.queue:
            return 0
        seed = min(self.queue, key=self._edf_key)
        gkey = self._group_key(seed)
        batch: list[GenerateRequest] = [seed]
        rest: deque[GenerateRequest] = deque()
        for r in self.queue:
            if r is seed:
                continue
            if len(batch) < self.max_batch and self._group_key(r) == gkey:
                batch.append(r)
            else:
                rest.append(r)
        self.queue = rest
        for i, r in enumerate(batch):
            self.bus.emit(ev.Admitted, r.rid, slot=i)
        self._run_batch(batch, gkey)
        return len(batch)

    def run(self, max_steps: int = 10_000) -> list[GenerateResult]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return list(self.finished)

    # ------------------------------------------------------ internals
    def _edf_key(self, req: GenerateRequest) -> tuple:
        """Expired deadlines sort behind feasible ones, then EDF, then
        priority, then arrival (no deadlines -> FIFO)."""
        seq, deadline, prio = self._meta[req.rid]
        return (deadline < self.bus.clock(), deadline, -prio, seq)

    def _group_key(self, req: GenerateRequest) -> tuple:
        fixed = samplers_mod.get_sampler(req.sampler).fixed_steps
        return (req.sampler, fixed or req.steps,
                req.latent_hw or self.cfg.latent_hw,
                uses_cfg(req.neg_tokens, req.guidance_scale))

    def _pack(self, reqs: list[GenerateRequest], hw: int) -> tuple:
        """Batch request rows, padding to the bucket with row 0 (padded
        rows are replicas and are discarded at retire)."""
        tl = self.cfg.text_len

        def tok(t):
            return torch.as_tensor(t, dtype=torch.long).reshape(tl).cpu()

        toks = [tok(r.tokens) for r in reqs]
        negs = [tok(r.neg_tokens) if r.neg_tokens is not None
                else torch.zeros((tl,), dtype=torch.long) for r in reqs]
        noises = [torch.as_tensor(self.noise_fn(r, hw),
                                  dtype=torch.float32).cpu() for r in reqs]
        scales = [float(r.guidance_scale) for r in reqs]
        while len(toks) < self.max_batch:
            toks.append(toks[0])
            negs.append(negs[0])
            noises.append(noises[0])
            scales.append(scales[0])
        dev = self.device
        return (torch.stack(toks).to(dev), torch.stack(negs).to(dev),
                torch.tensor(scales, dtype=torch.float32, device=dev),
                torch.stack(noises).to(dev))

    def _run_batch(self, reqs: list[GenerateRequest], gkey: tuple) -> None:
        sampler_name, steps, hw, use_cfg = gkey
        toks, negs, scales, noises = self._pack(reqs, hw)
        sampler = samplers_mod.get_sampler(sampler_name)
        plan = sampler.plan(sched_mod.NoiseSchedule(), steps,
                            steps_bucket(steps))
        fn = build_denoise(self.cfg, sampler_name, use_cfg)
        with torch.no_grad():
            imgs = fn(self.params, toks, negs, scales, noises, plan)
        for i, r in enumerate(reqs):
            res = GenerateResult(rid=r.rid, image=imgs[i],
                                 sampler=sampler_name, steps=steps,
                                 seed=r.seed, decode_steps=steps)
            self.finished.append(res)
            self.bus.emit(ev.Finished, r.rid, result=res)
