"""Phase-aware service-time cost model + feasibility admission control
(a copy of ``repro.engine.costmodel``; ``save``/``load`` keep its JSON
format and version, so a table written by either package loads in the
other).

The paper's evaluation decomposes Stable Diffusion into per-phase
costs — CLIP text encode, per-step UNet denoise, VAE decode (the
Fig. 11 phase breakdown) — and its companion LLM-serving study budgets
prefill and decode separately.  :class:`CostModel` carries that
decomposition into the serving stack: a table of per-phase costs, one
entry per *compiled-program shape*, that every engine can consult to
answer "how long will this request take?" *before* running it.

Phase keys
----------

Diffusion (per program the reference compiles; ``b`` is the engine's batch bucket,
``wq`` the engine's ``weight_quant`` policy name or ``None``)::

    ("diff", model, "clip",      use_cfg, b, wq)        one prompt encode
    ("diff", model, "unet_step", sampler, hw, use_cfg, b, wq)
                                                        one denoise step
    ("diff", model, "vae",       hw, b, wq)             finalize + decode
    ("diff", model, "fused", sampler, sbucket, hw, use_cfg, b, wq)
                                whole fused-scan program (clip + sbucket
                                padded steps + vae in one launch)

LM (per scheduling quantum; ``fused`` is the batcher's *executed*
prefill path — both it and the dispatch in ``lm_prefill_chunk`` derive
from ``models.transformer.prefill_path``, so an estimate can never be
keyed on a path the quantum doesn't take)::

    ("lm", model, "prefill", fused, quantized_kv, wq)   one prompt chunk
    ("lm", model, "decode",  quantized_kv, wq)          one batched token
    ("lm", model, "decode-spec", draft, k, quantized_kv, wq)
                                one speculative round (k draft steps +
                                one verification launch); estimates
                                divide by the batcher's observed
                                tokens-per-round acceptance rate

ASR (per scheduling quantum of the reference's ``AsrEngine``, which
the port does not have yet — the encoder-decoder modality adds an
ingestion phase in front of the LM pair)::

    ("asr", model, "encode-chunk", wq)                  one audio chunk
    ("asr", model, "prefill", fused, quantized_kv, wq)  one prompt chunk
    ("asr", model, "decode-token", quantized_kv, wq)    one batched token

Seeding and refinement
----------------------

Costs are seeded by **calibration micro-runs** (:func:`calibrate`
submits deadline-free sample requests and drains the engine; the
engine's per-quantum observations land in the table) or explicitly via
:meth:`CostModel.seed`.  They are then refined **online** by an EWMA
over the same observations the engines keep making in production: each
quantum's duration is measured on the engine's injectable clock — the
clock that timestamps the ``EventBus`` events, so virtual-time
benchmarks calibrate in virtual time — and folded in with
``cost = (1 - alpha) * cost + alpha * observed``.  Engines skip the
first observation of each program shape (the reference pays its jit
trace there; the port its one-off first-call costs: kernel builds,
cuBLAS heuristics, allocator growth), which would poison the
steady-state estimate.

Consumers
---------

* ``submit()`` on both engines rejects a request whose estimated
  service time exceeds its ``deadline_ms`` budget (terminal
  :class:`~repro_torch.engine.events.Rejected` event, no queue/slot/KV state
  ever allocated).
* Both engines sweep queued requests whose deadline expired or became
  infeasible to ``Rejected`` on each ``step()`` (bounded queues).
* :class:`~repro_torch.engine.router.EngineRouter` steps the engine with the
  least *slack* (deadline − now − estimated remaining service) instead
  of the raw earliest deadline.
* ``ContinuousBatcher(preempt_over_budget=True)`` evicts decodes
  *predicted* to overrun (now + remaining tokens × decode cost past
  the deadline) instead of waiting for the overrun to happen.

Estimates are intentionally simple: they return ``None`` — "admit
optimistically" — whenever a needed phase has never been observed.
Submit-time feasibility additionally charges :meth:`CostModel.queue_wait`
— the summed estimates of already-queued work amortized over the
engine's parallelism — so a request that is feasible in isolation but
sits behind a deep queue is correctly ``Rejected`` up front.  The
queue-wait term applies ONLY at submission: expiry sweeps and pop-time
checks re-test against the service estimate alone (the wait already
elapsed on the wall clock by then; charging it again would
double-count).  Diffusion estimates DO apply a co-batching
discount (queued requests sharing a group key ride one compiled
program, so each one's expected cost is the program cost over the
occupancy); the table itself persists across restarts via
:meth:`CostModel.save`/:meth:`CostModel.load` (versioned JSON).
Everything here is pure host Python; no tensors.
"""
from __future__ import annotations

import json
from typing import Any, Iterable

from repro_torch.engine.api import GenerateRequest, is_transcribe, uses_cfg
from repro_torch.engine.diffusion_engine import steps_bucket
from repro_torch.engine.samplers import get_sampler


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class CostModel:
    """Per-phase EWMA cost table shared by the serving engines.

    One instance may be shared across engines (the keys carry the
    engine kind and model name), or each engine can own its own.
    ``alpha`` is the EWMA weight of a fresh observation.
    """

    def __init__(self, alpha: float = 0.3, metrics=None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._costs: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = {}
        # Optional telemetry sink (repro_torch.obs.Telemetry or a bare
        # MetricsRegistry, duck-typed): every observe() against an
        # existing estimate records |actual - estimate| / estimate in
        # an error histogram per (engine, model, phase) — the
        # estimate-vs-actual signal the queueing-delay-aware work
        # needs.  Not persisted by save()/load().
        self.metrics = metrics

    # --------------------------------------------------------- table
    def seed(self, key: tuple, cost_s: float) -> None:
        """Set a phase cost directly (calibration table / persisted
        snapshot restore); later ``observe()`` calls refine it."""
        self._costs[key] = float(cost_s)
        self._counts.setdefault(key, 0)

    def observe(self, key: tuple, cost_s: float) -> None:
        """Fold one measured phase duration into the EWMA."""
        cur = self._costs.get(key)
        if cur is not None and self.metrics is not None:
            from repro_torch.obs.metrics import DEFAULT_ERROR_BUCKETS
            rel = abs(float(cost_s) - cur) / max(abs(cur), 1e-12)
            self.metrics.histogram(
                "cost_model_rel_error",
                "relative estimate-vs-actual error per phase "
                "(|actual - estimate| / estimate, pre-EWMA-fold)",
                labels=("engine", "model", "phase"),
                buckets=DEFAULT_ERROR_BUCKETS,
            ).observe(rel, engine=str(key[0]), model=str(key[1]),
                      phase=str(key[2]))
        self._costs[key] = (float(cost_s) if cur is None else
                            (1 - self.alpha) * cur + self.alpha * cost_s)
        self._counts[key] = self._counts.get(key, 0) + 1

    def cost(self, key: tuple) -> float | None:
        """Current estimate for one phase key (None if never seen)."""
        return self._costs.get(key)

    def snapshot(self) -> dict[tuple, tuple[float, int]]:
        """``key -> (cost_s, observation count)`` — introspection and
        cross-engine calibration persistence (see :meth:`save`)."""
        return {k: (v, self._counts.get(k, 0))
                for k, v in self._costs.items()}

    # ---------------------------------------------------- persistence
    SNAPSHOT_VERSION = 1

    def save(self, path: str) -> None:
        """Persist the cost table as versioned JSON so calibration
        survives restarts (and can seed CI runs).  Phase keys are
        tuples of str/int/bool/float — JSON lists round-trip every
        element type exactly, so ``load(save())`` is lossless."""
        rec = {
            "version": self.SNAPSHOT_VERSION,
            "alpha": self.alpha,
            "entries": [{"key": list(k), "cost_s": c,
                         "count": self._counts.get(k, 0)}
                        for k, c in sorted(self._costs.items(),
                                           key=lambda kv: repr(kv[0]))],
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CostModel":
        """Restore a :meth:`save`-d table.  Raises ``ValueError`` on a
        version the current code does not understand (snapshots are a
        contract, not a cache: silently dropping entries would skew
        every estimate built on them)."""
        with open(path) as f:
            rec = json.load(f)
        if not isinstance(rec, dict) \
                or rec.get("version") != cls.SNAPSHOT_VERSION:
            raise ValueError(
                f"cost-model snapshot version "
                f"{rec.get('version') if isinstance(rec, dict) else rec!r}"
                f" != {cls.SNAPSHOT_VERSION}")
        cm = cls(alpha=float(rec.get("alpha", 0.3)))
        for e in rec["entries"]:
            key = tuple(e["key"])
            cm._costs[key] = float(e["cost_s"])
            cm._counts[key] = int(e.get("count", 0))
        return cm

    # ----------------------------------------------- diffusion phases
    def _diff_keys(self, eng: Any, req: GenerateRequest) -> dict:
        cfg = eng.cfg
        hw = req.latent_hw or cfg.latent_hw
        ucfg = uses_cfg(req.neg_tokens, req.guidance_scale)
        steps = get_sampler(req.sampler).fixed_steps or req.steps
        b = eng.max_batch
        m = cfg.name
        wq = getattr(eng, "weight_quant", None)
        return dict(
            steps=steps,
            fused=("diff", m, "fused", req.sampler, steps_bucket(steps),
                   hw, ucfg, b, wq),
            clip=("diff", m, "clip", ucfg, b, wq),
            unet=("diff", m, "unet_step", req.sampler, hw, ucfg, b, wq),
            vae=("diff", m, "vae", hw, b, wq),
        )

    def _co_batch(self, eng: Any, req: GenerateRequest) -> int:
        """Expected program occupancy for ``req``: how many requests
        (itself included, capped at the batch bucket) would share the
        compiled program it joins — queued requests with the same
        group key co-batch into ONE launch."""
        group_key = getattr(eng, "_group_key", None)
        queue = getattr(eng, "queue", None)
        if group_key is None or queue is None:
            return 1
        gk = group_key(req)
        n = 1 + sum(1 for r in queue
                    if r is not req and group_key(r) == gk)
        return max(1, min(n, eng.max_batch))

    def estimate_diffusion(self, eng: Any,
                           req: GenerateRequest) -> float | None:
        """Expected per-request service time for a ``DiffusionEngine``
        request: the fused program's own cost when that exact shape has
        been observed, else the Fig.-11 phase composition
        ``clip + steps x unet_step + vae`` (padded pow2 steps on the
        fused path, exact steps on the segmented preview path).
        ``None`` if a needed phase was never observed.

        The program cost is **amortized over the co-batch**: phase
        costs are observed per compiled program at the engine's batch
        bucket, and queued requests with the same group key ride the
        SAME launch, so a request's expected share is the program cost
        divided by the occupancy (pricing each of n co-batched
        requests at the full program cost would treat them as n serial
        programs and over-reject feasible work)."""
        k = self._diff_keys(eng, req)
        share = self._co_batch(eng, req)
        if not req.preview_every:
            c = self.cost(k["fused"])
            if c is not None:
                return c / share
            eff = steps_bucket(k["steps"])   # fused scan pays padding
        else:
            eff = k["steps"]                 # segmented path is exact
        cc, cu, cv = (self.cost(k["clip"]), self.cost(k["unet"]),
                      self.cost(k["vae"]))
        if cc is None or cu is None or cv is None:
            return None
        return (cc + eff * cu + cv) / share

    def remaining_diffusion(self, eng: Any, req: GenerateRequest,
                            steps_done: int) -> float | None:
        """Remaining service time for a request ``steps_done`` deep in
        a segmented (preview) batch: the steps left plus the VAE tail
        (CLIP already paid)."""
        k = self._diff_keys(eng, req)
        cu, cv = self.cost(k["unet"]), self.cost(k["vae"])
        if cu is None or cv is None:
            return None
        return max(0, k["steps"] - steps_done) * cu + cv

    # ------------------------------------------------------ LM phases
    def lm_keys(self, cb: Any) -> tuple[tuple, tuple]:
        """(prefill key, decode key) for a ``ContinuousBatcher``.

        ``cb.fused_prefill`` is the executed path (the batcher derives
        it from ``prefill_path``, the same predicate that dispatches
        inside ``lm_prefill_chunk``), so calibration seeds the path a
        production quantum will actually take."""
        m = cb.cfg.name
        wq = getattr(cb, "weight_quant", None)
        return (("lm", m, "prefill", cb.fused_prefill, cb.quantized_kv,
                 wq),
                ("lm", m, "decode", cb.quantized_kv, wq))

    def lm_spec_key(self, cb: Any) -> tuple:
        """Phase key for one speculative decode round on a
        ``ContinuousBatcher`` running with ``spec_decode``: keyed on
        (target model, draft model, proposal length K) plus the usual
        pool/weight quantization discriminators — the round's cost is
        K draft steps + one verification launch, so a different draft
        or K compiles (and costs) differently."""
        m = cb.cfg.name
        wq = getattr(cb, "weight_quant", None)
        sp = cb.spec
        return ("lm", m, "decode-spec", sp.draft_cfg.name, sp.k,
                cb.quantized_kv, wq)

    def _lm_decode_term(self, cb: Any, ndec: int) -> float | None:
        """Decode-side service time for ``ndec`` tokens: plain batched
        quanta, or — with speculation on — ``decode-spec`` rounds at
        the batcher's observed tokens-per-round rate."""
        if getattr(cb, "spec", None) is not None:
            cs = self.cost(self.lm_spec_key(cb))
            if cs is None:
                return None
            return ndec / cb.spec_tokens_per_round() * cs
        cd = self.cost(self.lm_keys(cb)[1])
        if cd is None:
            return None
        return ndec * cd

    def estimate_lm(self, cb: Any, req: Any) -> float | None:
        """Whole-request (or, after a preemption, remaining) service
        time for an LM ``serving.Request``: chunked-prefill quanta for
        the feed plus the decode term — one batched decode quantum per
        token still to generate (the final prefill chunk emits the
        first token), or speculative rounds at the observed acceptance
        rate when ``spec_decode`` is on.  ``None`` if prefill or the
        decode phase actually in use has never been observed."""
        kp, _ = self.lm_keys(cb)
        cp = self.cost(kp)
        if cp is None:
            return None
        feed = req._feed if req._feed else list(req.prompt)
        chunks = _cdiv(max(1, len(feed)), cb.prefill_chunk)
        ndec = max(0, req.max_new - len(req.out) - 1)
        dec = self._lm_decode_term(cb, ndec)
        if dec is None:
            return None
        return chunks * cp + dec

    def remaining_lm(self, cb: Any, slot: int) -> float | None:
        """Remaining service time for the request running in ``slot``:
        its pending prefill chunks plus its remaining decode tokens
        (speculation-aware, like :meth:`estimate_lm`)."""
        req = cb.slots[slot]
        if req is None:
            return None
        kp, _ = self.lm_keys(cb)
        cp = self.cost(kp)
        if cp is None:
            return None
        pending = len(cb._pending[slot])
        chunks = _cdiv(pending, cb.prefill_chunk) if pending else 0
        ndec = max(0, req.max_new - len(req.out) - (1 if pending else 0))
        dec = self._lm_decode_term(cb, ndec)
        if dec is None:
            return None
        return chunks * cp + dec

    # ----------------------------------------------------- ASR phases
    def asr_keys(self, eng: Any) -> tuple[tuple, tuple, tuple]:
        """(encode key, prefill key, decode key) for an ``AsrEngine``.

        Encode cost is per audio chunk: each quantum re-runs the full
        encoder over the slot's frame buffer, so its cost is set by
        ``cfg.encoder_seq``, not by how many frames the chunk added —
        one key covers every chunk size."""
        m = eng.cfg.name
        wq = getattr(eng, "weight_quant", None)
        return (("asr", m, "encode-chunk", wq),
                ("asr", m, "prefill", eng.fused_prefill, eng.quantized_kv,
                 wq),
                ("asr", m, "decode-token", eng.quantized_kv, wq))

    def estimate_asr(self, eng: Any, req: Any) -> float | None:
        """Whole-request (or, after a preemption, remaining) service
        time for a ``TranscribeRequest``: encode quanta for the full
        audio span, chunked-prefill quanta for the decoder feed, one
        batched decode quantum per token still to generate.  The
        encode term is conservative — an audio prefix-cache adoption
        would skip it, but admission can't know the cache state at the
        request's eventual admit time.  ``None`` if any needed phase
        was never observed."""
        ke, kp, kd = self.asr_keys(eng)
        ce, cp, cd = self.cost(ke), self.cost(kp), self.cost(kd)
        if ce is None or cp is None or cd is None:
            return None
        enc = _cdiv(eng.cfg.encoder_seq, eng.audio_chunk)
        feed = req._feed if req._feed else list(req.prompt)
        chunks = _cdiv(max(1, len(feed)), eng.prefill_chunk)
        ndec = max(0, req.max_new - len(req.out) - 1)
        return enc * ce + chunks * cp + ndec * cd

    def remaining_asr(self, eng: Any, slot: int) -> float | None:
        """Remaining service time for the request running in ``slot``:
        audio frames still to ingest, pending prefill chunks, then the
        remaining decode tokens."""
        req = eng.slots[slot]
        if req is None:
            return None
        ke, kp, kd = self.asr_keys(eng)
        ce, cp, cd = self.cost(ke), self.cost(kp), self.cost(kd)
        if ce is None or cp is None or cd is None:
            return None
        left = eng._audio_left[slot]
        enc = _cdiv(left, eng.audio_chunk) if left else 0
        pending = len(eng._pending[slot])
        chunks = _cdiv(pending, eng.prefill_chunk) if pending else 0
        ndec = max(0, req.max_new - len(req.out) - (1 if pending else 0))
        return enc * ce + chunks * cp + ndec * cd

    # ------------------------------------------------------- generic
    def estimate(self, engine: Any, request: Any) -> float | None:
        """Dispatch on request type: ``GenerateRequest`` -> diffusion,
        ``TranscribeRequest`` -> ASR, anything else -> LM."""
        if isinstance(request, GenerateRequest):
            return self.estimate_diffusion(engine, request)
        if is_transcribe(request):
            return self.estimate_asr(engine, request)
        return self.estimate_lm(engine, request)

    def queue_wait(self, engine: Any) -> float:
        """Expected queueing delay a newly submitted request inherits:
        the summed service estimates of everything already queued,
        amortized over the engine's admission parallelism (slot count
        for the slotted engines; 1 for diffusion, whose queue drains
        one program at a time — co-batching is already priced into the
        per-request diffusion estimates).  Unobserved phases contribute
        0 (optimistic, matching the ``None`` admission convention)."""
        groups = getattr(engine, "_groups", None)
        if groups is not None:
            queued = [r for q in groups.values() for r in q]
        else:
            queued = list(getattr(engine, "queue", ()) or ())
        total = 0.0
        for r in queued:
            total += self.estimate(engine, r) or 0.0
        slots = getattr(engine, "slots", None)
        par = len(slots) if isinstance(slots, list) and slots else 1
        return total / par


def calibrate(engine: Any, requests: Iterable[Any],
              max_steps: int = 10_000) -> CostModel:
    """Seed an engine's attached cost model with a calibration
    micro-run: submit the (deadline-free) sample requests and drain
    the engine; its per-quantum observations populate the table.
    Returns the engine's cost model for chaining."""
    cm = engine.cost_model
    if cm is None:
        raise ValueError("engine has no cost model attached")
    for req in requests:
        engine.submit(req)
    engine.run(max_steps)
    return cm
