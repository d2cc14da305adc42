"""Request-based text-to-image engine (CLIP -> UNet loop -> VAE).

The counterpart of ``repro.engine.diffusion_engine``:

* ``build_denoise`` returns ``fn(params, tokens, neg_tokens, gscale,
  noise, plan)``; its denoise loop is a Python loop over the sampler's
  step plan where the reference has one ``lax.scan``.  Each iteration is
  ``build_denoise_step``, the segmented path's one solver step, so the
  two paths run the same ops in the same order.  Padding steps
  (``valid`` False) are skipped: the reference masks them with
  ``jnp.where``, so the result is the same and no UNet runs for them.
* **Segmented preview path** — requests with ``preview_every > 0`` run
  ``build_encode`` once, ``build_denoise_step`` once per ``step()`` and
  ``build_finalize_decode`` at the end, so the host sees
  ``Progress(phase="denoise")`` after every step, a ``PreviewLatent``
  every ``preview_every`` steps and at the last (x0 latent, or pixels
  with ``preview_decode``), and can ``cancel()`` between steps.
* ``DiffusionEngine`` keeps the reference's host plumbing: ``submit`` /
  ``step`` / ``run`` / ``cancel``, earliest-deadline-first pop, batch
  buckets padded with row 0, ``weight_quant=``, ``config=``
  (``EngineConfig``) and the reference's events on its ``EventBus``.
* Initial noise comes from ``noise_fn(request, hw)``; the default draws
  ``torch.randn`` from a generator seeded with the request's seed.  It
  cannot reproduce ``jax.random``, so tests inject the reference's noise.
* **Serving surface** — ``evacuate``/``adopt`` for fleet migration (an
  adopted rid re-enters with ``Progress(phase="resume")``),
  ``next_deadline``/``next_slack`` for the router, ``quanta``;
  ``cost_model=`` (submit-time ``Rejected``, the per-step sweep of
  expired or infeasible queued requests, online EWMA observations) and
  ``metrics=`` (phase histograms and spans, queue gauges).
* **First-call accounting** — the reference compiles one program per
  key and skips the cost-model observation of any quantum that paid a
  trace.  The port runs eagerly, but the first call of a program key
  still pays one-off costs (kernel builds, cuBLAS heuristics, allocator
  growth), so ``traces`` counts the first sighting of each key the
  reference would compile, and the same quanta go unobserved.
* With a cost model or metrics attached, an observed quantum waits for
  the device (``torch.cuda.synchronize`` on a card) before it reads the
  clock; with neither, ``step()`` adds no host sync.
"""
from __future__ import annotations

from collections import deque
from typing import Callable

import torch

from repro_torch import resolve_device, sync_device
from repro_torch.configs.base import SD_TURBO, TINY_SD, SDConfig  # noqa: F401
from repro_torch.core.policy import OffloadPolicy, get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.tree import to_device
from repro_torch.diffusion import schedule as sched_mod
from repro_torch.engine import events as ev
from repro_torch.engine import samplers as samplers_mod
from repro_torch.engine.config import UNSET, EngineConfig, resolve
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
    encode = build_encode(cfg, use_cfg)
    denoise_step = build_denoise_step(cfg, sampler_name, use_cfg)
    finalize_decode = build_finalize_decode(cfg, sampler_name)

    def fn(params, tokens, neg_tokens, gscale, noise, plan):
        ctx, ctx_u = encode(params, tokens, neg_tokens)
        x = sampler.init_latent(noise.float(), plan)
        for i in range(plan["valid"].shape[0]):
            x = denoise_step(params, ctx, ctx_u, gscale, x,
                             {k: v[i] for k, v in plan.items()})
        if not decode:
            return sampler.finalize(x)
        return finalize_decode(params, x)
    return fn


def build_encode(cfg: SDConfig, use_cfg: bool) -> Callable:
    """Prompt-encoding half of the segmented path:
    ``fn(params, tokens, neg_tokens) -> (ctx, ctx_uncond | None)``."""
    clip_cfg = cfg.clip_cfg()

    def fn(params, tokens, neg_tokens):
        ctx = clip_mod.clip_encode(params["clip"], clip_cfg, tokens)
        ctx_u = (clip_mod.clip_encode(params["clip"], clip_cfg, neg_tokens)
                 if use_cfg else None)
        return ctx, ctx_u
    return fn


def build_denoise_step(cfg: SDConfig, sampler_name: str,
                       use_cfg: bool) -> Callable:
    """One solver step: ``fn(params, ctx, ctx_u, gscale, x, step) -> x``
    where ``step`` is one per-step slice of the sampler plan (0-d
    tensors).  An invalid (padding) step returns ``x`` unchanged."""
    sampler = samplers_mod.get_sampler(sampler_name)
    sched = sched_mod.NoiseSchedule()

    def fn(params, ctx, ctx_u, gscale, x, step):
        if not bool(step["valid"]):
            return x
        b = x.shape[0]
        g = gscale[:, None, None, None]
        xm, t = sampler.model_input(x, step)
        tb = t.to(device=x.device, dtype=torch.int32).expand(b)
        xb = xm.to(torch.bfloat16)
        eps = unet_mod.apply_unet(params["unet"], cfg.unet, xb, tb,
                                  ctx).float()
        if use_cfg:
            eps_u = unet_mod.apply_unet(params["unet"], cfg.unet, xb, tb,
                                        ctx_u).float()
            eps = eps_u + g * (eps - eps_u)
        return sampler.update(sched, x, eps, step)
    return fn


def build_finalize_decode(cfg: SDConfig, sampler_name: str) -> Callable:
    """Tail of both paths: ``fn(params, x) -> images`` applies the
    sampler's finalize, then the VAE decoder."""
    sampler = samplers_mod.get_sampler(sampler_name)

    def fn(params, x):
        x0 = sampler.finalize(x)
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
    group — same (sampler, steps, latent size, guidance mode, preview
    cadence) — seeded earliest-deadline-first, pads them to the batch
    bucket with row 0, and either runs the fused denoise program on
    ``device`` and retires the batch (no previews), or starts the
    segmented path and advances it one denoise step per ``step()``,
    emitting ``Progress``/``PreviewLatent`` and honouring ``cancel()``
    between steps.

    Construction takes ``config=EngineConfig(diffusion=...)`` or the
    loose kwargs; explicit kwargs win over the config.
    """

    def __init__(self, params: dict, cfg: SDConfig, *,
                 config: EngineConfig | None = None,
                 max_batch: int = UNSET,
                 bus: ev.EventBus | None = UNSET,
                 clock: Callable[[], float] = UNSET,
                 cost_model=UNSET, metrics=UNSET,
                 weight_quant: str | None = UNSET, device="cuda",
                 noise_fn: Callable[[GenerateRequest, int],
                                    torch.Tensor] | None = None):
        self.config, diffc = resolve(config, "diffusion", dict(
            max_batch=max_batch, bus=bus, clock=clock,
            cost_model=cost_model, metrics=metrics,
            weight_quant=weight_quant))
        weight_quant = self.config.weight_quant
        self.device = resolve_device(device)
        params = to_device(params, self.device)
        if weight_quant is not None:
            params = quantize_pipeline(params, get_policy(weight_quant))
        self.weight_quant = weight_quant
        self.params = params
        self.cfg = cfg
        self.max_batch = diffc.max_batch
        self.noise_fn = noise_fn or request_noise
        self.queue: deque[GenerateRequest] = deque()
        self.finished: list[GenerateResult] = []
        self.bus = (self.config.bus if self.config.bus is not None
                    else ev.EventBus(self.config.clock))
        self._inflight: dict | None = None      # segmented batch state
        self._meta: dict[int, tuple] = {}       # rid -> (seq, deadline, prio)
        self._subseq = 0
        self.cost_model = self.config.cost_model  # None: no admission control
        self.rejections = 0
        self.metrics = self.config.metrics      # None: no instrumentation
        self.quanta = 0                         # non-idle step() count
        # First calls of the program keys the reference compiles (see the
        # module docstring); a quantum that adds one goes unobserved.
        self.traces = 0
        self._seen: set[tuple] = set()

    # ------------------------------------------------------------ API
    def submit(self, request: GenerateRequest) -> ev.RequestHandle:
        samplers_mod.get_sampler(request.sampler)   # fail fast on typos
        if request.steps < 1:
            raise ValueError(f"steps must be >= 1, got {request.steps}")
        if request.preview_every < 0:
            raise ValueError(
                f"preview_every must be >= 0, got {request.preview_every}")
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
        if self.metrics is not None:
            # Before admission control, so requests rejected here are
            # visible to telemetry too (submission is not a bus event).
            self.metrics.request_submitted(request.rid, "diffusion",
                                           self.bus.clock())
        if self.cost_model is not None and request.deadline_ms is not None:
            est = self.cost_model.estimate_diffusion(self, request)
            if est is not None:
                # Charge the expected wait behind already-queued work.
                est += self.cost_model.queue_wait(self)
            budget = request.deadline_ms / 1e3
            if est is not None and est > budget:
                self.rejections += 1
                self.bus.emit(ev.Rejected, request.rid, estimated_s=est,
                              budget_s=budget, reason="infeasible")
                return self.handle(request.rid)
        deadline = (float("inf") if request.deadline_ms is None
                    else self.bus.clock() + request.deadline_ms / 1e3)
        request._deadline = deadline
        self._meta[request.rid] = (self._subseq, deadline, request.priority)
        self._subseq += 1
        self.queue.append(request)
        self._obs_sched()
        return self.handle(request.rid)

    # ------------------------------------------- fleet migration hooks
    def evacuate(self, reason: str = "evacuate") -> list[GenerateRequest]:
        """Return every live request for another engine to ``adopt()``:
        the in-flight segmented ones first (``Preempted`` emitted, their
        partial denoise abandoned), then the queue in arrival order, with
        no terminal events.  A rerun from the seed gives the same image:
        the seed alone sets the initial latent."""
        out: list[GenerateRequest] = []
        st = self._inflight
        if st is not None:
            for r in st["reqs"]:
                if r.rid not in st["cancelled"]:
                    self.bus.emit(ev.Preempted, r.rid, reason=reason)
                    out.append(r)
            self._inflight = None
        out.extend(self.queue)
        self.queue = deque()
        for r in out:
            self._meta.pop(r.rid, None)
        return out

    def adopt(self, request: GenerateRequest) -> ev.RequestHandle:
        """Admit a request evacuated from another engine on the same bus:
        no duplicate-rid guard (its admission lives on the bus), no
        submit-time rejection (the per-step sweep still applies), and its
        original absolute deadline (``request._deadline``).  At batch pop
        an already-admitted rid re-enters with
        ``Progress(phase="resume")``, never a second ``Admitted``."""
        self._meta[request.rid] = (self._subseq, request._deadline,
                                   request.priority)
        self._subseq += 1
        self.queue.append(request)
        return self.handle(request.rid)

    def has_work(self) -> bool:
        return bool(self.queue) or self._inflight is not None

    def next_deadline(self) -> float:
        """Earliest deadline over queued and in-flight requests (+inf if
        none declares one): the router's multiplex key."""
        cands = [self._meta[r.rid][1] for r in self.queue]
        if self._inflight is not None:
            cands += [self._meta[r.rid][1] for r in self._inflight["reqs"]
                      if r.rid not in self._inflight["cancelled"]]
        return min(cands, default=float("inf"))

    def next_slack(self) -> float:
        """Least estimated slack (deadline - now - estimated remaining
        service) over queued and in-flight requests; +inf when none
        declares a deadline.  A request the cost model cannot price yet
        (or every request, without one) counts 0 service: raw deadline
        order."""
        cm = self.cost_model
        now = self.bus.clock()
        best = float("inf")
        for r in self.queue:
            dl = self._meta[r.rid][1]
            if dl == float("inf"):
                continue
            est = cm.estimate_diffusion(self, r) if cm else None
            best = min(best, dl - now - (est or 0.0))
        st = self._inflight
        if st is not None:
            for r in st["reqs"]:
                if r.rid in st["cancelled"]:
                    continue
                dl = self._meta[r.rid][1]
                if dl == float("inf"):
                    continue
                est = (cm.remaining_diffusion(self, r, st["i"])
                       if cm else None)
                best = min(best, dl - now - (est or 0.0))
        return best

    def cancel(self, rid: int) -> bool:
        """Abort a request: a queued one leaves the queue; one inside a
        segmented batch stops emitting and is dropped at the batch's end
        (its row keeps computing: co-batched rows keep the batch shape).
        A fused batch retires atomically and cannot be cancelled."""
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                self.bus.emit(ev.Cancelled, rid)
                return True
        st = self._inflight
        if st is not None:
            for r in st["reqs"]:
                if r.rid == rid and rid not in st["cancelled"]:
                    st["cancelled"].add(rid)
                    self.bus.emit(ev.Cancelled, rid)
                    return True
        return False

    def step(self) -> int:
        """One quantum: advance the in-flight segmented batch by one
        denoise step, or pop and run a new micro-batch; returns the
        number of requests progressed (0 if idle)."""
        if self.cost_model is not None and self.queue:
            self._sweep_infeasible()
        if self._inflight is not None:
            self.quanta += 1
            self._obs_sched()
            return self._segment_quantum()
        if not self.queue:
            return 0
        self.quanta += 1
        self._obs_sched()
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
            if self.bus.admitted(r.rid):   # adopted after a migration
                self.bus.emit(ev.Progress, r.rid, phase="resume",
                              step=0, total=gkey[1])
            else:
                self.bus.emit(ev.Admitted, r.rid, slot=i)
        if gkey[4]:                      # preview_every > 0: segmented
            self._start_segmented(batch, gkey)
            return self._segment_quantum()
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

    def _sweep_infeasible(self) -> None:
        """Once per ``step()`` with a cost model: queued requests whose
        deadline expired, or that can no longer meet it (now + estimated
        service > deadline), end ``Rejected``."""
        now = self.bus.clock()
        keep: deque[GenerateRequest] = deque()
        for r in self.queue:
            dl = self._meta[r.rid][1]
            if dl == float("inf"):
                keep.append(r)
                continue
            expired = dl < now
            est = self.cost_model.estimate_diffusion(self, r)
            if expired or (est is not None and now + est > dl):
                self.rejections += 1
                self.bus.emit(ev.Rejected, r.rid, estimated_s=est or 0.0,
                              budget_s=dl - now,
                              reason="expired" if expired
                              else "infeasible")
            else:
                keep.append(r)
        self.queue = keep

    def _first_call(self, key: tuple) -> None:
        """Count the first call of a program key (the reference's trace)."""
        if key not in self._seen:
            self._seen.add(key)
            self.traces += 1

    def _observe(self, key: tuple, t0: float, traces0: int) -> None:
        """Feed one quantum's duration to the cost model, unless the
        quantum made a first call (its one-off costs would poison the
        steady-state EWMA); waits for the device first."""
        if self.cost_model is None or self.traces != traces0:
            return
        sync_device(self.device)
        self.cost_model.observe(key, self.bus.clock() - t0)

    def _obs_phase(self, phase: str, t0: float, rids: list,
                   args: dict | None = None) -> None:
        """Phase telemetry (histogram and span).  Unlike ``_observe`` it
        keeps first-call quanta, so phase counts reconcile with the
        events and ``quanta``."""
        if self.metrics is None:
            return
        sync_device(self.device)
        self.metrics.phase("diffusion", phase, t0, self.bus.clock(),
                           rids=rids, args=args)

    def _obs_sched(self) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge(
            "engine_queue_depth", "queued requests by engine",
            labels=("engine",)).set(len(self.queue), engine="diffusion")
        st = self._inflight
        live = 0 if st is None else sum(
            1 for r in st["reqs"] if r.rid not in st["cancelled"])
        self.metrics.gauge(
            "diffusion_inflight",
            "live requests in the segmented in-flight batch").set(live)
        self.metrics.gauge("diffusion_traces",
                           "cumulative jit traces").set(self.traces)

    def _group_key(self, req: GenerateRequest) -> tuple:
        fixed = samplers_mod.get_sampler(req.sampler).fixed_steps
        # preview_decode joins the key only when previews stream, so
        # plain requests never split batches over it.
        return (req.sampler, fixed or req.steps,
                req.latent_hw or self.cfg.latent_hw,
                uses_cfg(req.neg_tokens, req.guidance_scale),
                req.preview_every,
                bool(req.preview_every and req.preview_decode))

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

    def _finish(self, r: GenerateRequest, image, sampler_name: str,
                steps: int) -> None:
        res = GenerateResult(rid=r.rid, image=image, sampler=sampler_name,
                             steps=steps, seed=r.seed, decode_steps=steps)
        self.finished.append(res)
        self.bus.emit(ev.Finished, r.rid, result=res)

    # ------------------------------------------------- fused path
    def _run_batch(self, reqs: list[GenerateRequest], gkey: tuple) -> None:
        sampler_name, steps, hw, use_cfg = gkey[:4]
        toks, negs, scales, noises = self._pack(reqs, hw)
        sbucket = steps_bucket(steps)
        sampler = samplers_mod.get_sampler(sampler_name)
        plan = sampler.plan(sched_mod.NoiseSchedule(), steps, sbucket)
        fn = build_denoise(self.cfg, sampler_name, use_cfg)
        t0, tr0 = self.bus.clock(), self.traces
        self._first_call((sampler_name, sbucket, hw, use_cfg,
                          self.max_batch))
        with torch.no_grad():
            imgs = fn(self.params, toks, negs, scales, noises, plan)
        self._observe(("diff", self.cfg.name, "fused", sampler_name,
                       sbucket, hw, use_cfg, self.max_batch,
                       self.weight_quant), t0, tr0)
        self._obs_phase("fused", t0, [r.rid for r in reqs],
                        args={"steps": steps, "batch": len(reqs),
                              "weight_quant": self.weight_quant})
        for i, r in enumerate(reqs):
            self._finish(r, imgs[i], sampler_name, steps)

    # ------------------------------------------------- segmented path
    def _start_segmented(self, reqs: list[GenerateRequest],
                         gkey: tuple) -> None:
        sampler_name, steps, hw, use_cfg = gkey[:4]
        toks, negs, scales, noises = self._pack(reqs, hw)
        t0, tr0 = self.bus.clock(), self.traces
        self._first_call(("enc", use_cfg, self.max_batch))
        with torch.no_grad():
            ctx, ctx_u = build_encode(self.cfg, use_cfg)(self.params, toks,
                                                          negs)
        self._observe(("diff", self.cfg.name, "clip", use_cfg,
                       self.max_batch, self.weight_quant), t0, tr0)
        self._obs_phase("clip", t0, [r.rid for r in reqs],
                        args={"batch": len(reqs),
                              "weight_quant": self.weight_quant})
        sampler = samplers_mod.get_sampler(sampler_name)
        # Unpadded plan: one solver step serves any step count.
        plan = sampler.plan(sched_mod.NoiseSchedule(), steps, steps)
        self._inflight = dict(
            reqs=reqs, key=(sampler_name, steps, hw, use_cfg),
            x=sampler.init_latent(noises.float(), plan), ctx=ctx,
            ctx_u=ctx_u, g=scales, plan=plan, i=0, cancelled=set(),
            step_fn=build_denoise_step(self.cfg, sampler_name, use_cfg),
            decode_fn=build_finalize_decode(self.cfg, sampler_name))

    def _decode_latent(self, st: dict, rids: list,
                       preview: bool) -> torch.Tensor:
        """The finalize + VAE pass on the in-flight latent, observed as
        the reference observes its ``dec`` program."""
        sampler_name, _steps, hw, _use_cfg = st["key"]
        t0, tr0 = self.bus.clock(), self.traces
        self._first_call(("dec", sampler_name, hw, self.max_batch))
        with torch.no_grad():
            imgs = st["decode_fn"](self.params, st["x"])
        self._observe(("diff", self.cfg.name, "vae", hw, self.max_batch,
                       self.weight_quant), t0, tr0)
        args = {"weight_quant": self.weight_quant}
        self._obs_phase("vae", t0, rids,
                        args=dict(preview=True, **args) if preview else args)
        return imgs

    def _segment_quantum(self) -> int:
        st = self._inflight
        sampler_name, steps, hw, use_cfg = st["key"]
        live = [(row, r) for row, r in enumerate(st["reqs"])
                if r.rid not in st["cancelled"]]
        if not live:                     # everyone cancelled mid-flight
            self._inflight = None
            return 0
        i = st["i"]
        step_slice = {k: v[i] for k, v in st["plan"].items()}
        t0, tr0 = self.bus.clock(), self.traces
        self._first_call(("seg", sampler_name, hw, use_cfg, self.max_batch))
        with torch.no_grad():
            st["x"] = st["step_fn"](self.params, st["ctx"], st["ctx_u"],
                                    st["g"], st["x"], step_slice)
        self._observe(("diff", self.cfg.name, "unet_step", sampler_name,
                       hw, use_cfg, self.max_batch, self.weight_quant),
                      t0, tr0)
        self._obs_phase("unet_step", t0, [r.rid for _row, r in live],
                        args={"step": i + 1, "total": steps,
                              "weight_quant": self.weight_quant})
        st["i"] = i + 1
        sampler = samplers_mod.get_sampler(sampler_name)
        at_stride = [(row, r) for row, r in live
                     if st["i"] % r.preview_every == 0 or st["i"] == steps]
        pv_imgs = None
        if any(r.preview_decode for _row, r in at_stride):
            # Pixel previews: the final decode's program on the current
            # latent; preview_decode is in the group key, so every row
            # of the batch opted in.
            pv_imgs = self._decode_latent(
                st, [r.rid for _row, r in at_stride], preview=True)
        for row, r in live:
            self.bus.emit(ev.Progress, r.rid, step=st["i"], total=steps,
                          phase="denoise")
        for row, r in at_stride:
            if r.preview_decode and pv_imgs is not None:
                self.bus.emit(ev.PreviewLatent, r.rid, step=st["i"],
                              total=steps, latent=pv_imgs[row],
                              decoded=True)
            else:
                self.bus.emit(ev.PreviewLatent, r.rid, step=st["i"],
                              total=steps,
                              latent=sampler.finalize(st["x"][row]))
        if st["i"] >= steps:
            # The last preview is the decode: at the last step every live
            # row is at its stride, so one VAE pass (observed once, where
            # the reference runs and observes its program twice) serves
            # the preview and the image.
            imgs = pv_imgs
            if imgs is None:
                imgs = self._decode_latent(st, [r.rid for _row, r in live],
                                           preview=False)
            for row, r in live:
                self._finish(r, imgs[row], sampler_name, steps)
            self._inflight = None
        return len(live)
