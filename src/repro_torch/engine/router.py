"""SLO-aware multiplexer: one streaming surface over every engine (the
port of ``repro.engine.router``).

:class:`EngineRouter` puts a :class:`repro_torch.engine.DiffusionEngine`,
an LM ``serving.ContinuousBatcher`` and an ``engine.asr_engine.AsrEngine``
(any object with the structural ``Engine`` protocol plus
``has_work()``/``next_deadline()``/``bus``) behind one
``submit()/step()/stream()/cancel()`` surface in one host loop:

* **Dispatch** — a ``GenerateRequest`` goes to the diffusion engine, a
  ``TranscribeRequest`` to the ASR engine (``api.is_transcribe``; a
  router without one raises on it), anything else (``serving.Request``) to the LM engine; rids are unique
  across the router.
* **One event bus** — at construction the router rebinds every engine
  onto one :class:`~repro_torch.engine.events.EventBus` (they must not
  have emitted yet), so ``stream()`` yields one totally ordered merge of
  every modality's events, and its handles pump the router.
* **SLO-aware scheduling** — each ``step()`` advances the engine whose
  pending work has the earliest deadline (``next_deadline()``); ties go
  round-robin, so a deadline-free backlog of one kind cannot starve the
  other.
* **Cost-model urgency** — when every busy engine carries a
  :class:`repro_torch.engine.costmodel.CostModel`, the key becomes the
  estimated slack (``next_slack()``: deadline - now - estimated
  remaining service) instead of the raw deadline.  Without cost models
  the router keeps the earliest-deadline rule.
* **``run()``** drains the stream and returns every ``Finished``
  payload in completion order.

The router itself launches nothing: every kernel launch is one of the
engines' own.
"""
from __future__ import annotations

from typing import Any, Iterator

from repro_torch.engine import events as ev
from repro_torch.engine.api import GenerateRequest, is_transcribe


class EngineRouter(ev.EventStreamMixin):
    """Multiplexes diffusion, LM, and ASR engines behind one streaming
    Engine surface (any may be ``None``, at least one required)."""

    def __init__(self, diffusion: Any = None, lm: Any = None,
                 asr: Any = None, metrics=None):
        if diffusion is None and lm is None and asr is None:
            raise ValueError("router needs at least one engine")
        self.diffusion = diffusion
        self.lm = lm
        self.asr = asr
        self.metrics = metrics          # None -> no instrumentation
        self.engines = [e for e in (diffusion, lm, asr)
                        if e is not None]
        # Rebind every engine onto one shared bus (single clock, one
        # total event order).  Refuse once events exist: merging
        # populated buses would reorder history.
        self.bus = self.engines[0].bus
        for e in self.engines:
            if e.bus.log:
                raise ValueError(
                    "engines must join the router before emitting "
                    "events (their buses are rebound to a shared one)")
        for e in self.engines:
            e.bus = self.bus
        self._owner: dict[int, Any] = {}      # rid -> engine
        self._rr = 0                          # deadline-tie rotation

    def _dispatch(self, request: Any) -> Any:
        if isinstance(request, GenerateRequest):
            return self.diffusion
        if is_transcribe(request):
            return self.asr
        return self.lm

    # --------------------------------------------------------------- API
    def submit(self, request: Any) -> ev.RequestHandle:
        engine = self._dispatch(request)
        if engine is None:
            raise ValueError(
                f"no engine for {type(request).__name__} "
                f"(router has diffusion={self.diffusion is not None}, "
                f"lm={self.lm is not None}, "
                f"asr={self.asr is not None})")
        if request.rid in self._owner:
            raise ValueError(f"duplicate rid {request.rid} across router")
        engine.submit(request)
        self._owner[request.rid] = engine
        # The handle pumps the router, not the owning engine, so a
        # consumer blocked on one request keeps all work moving.
        return ev.RequestHandle(request.rid, self.bus, self.step,
                                self.cancel, self.has_work)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def next_deadline(self) -> float:
        return min((e.next_deadline() for e in self.engines),
                   default=float("inf"))

    def next_slack(self) -> float:
        """Minimum estimated slack over every engine's pending work
        (+inf when none declares a deadline) — the key a
        :class:`repro_torch.engine.fleet.FleetManager` multiplexes replica
        routers on, mirroring how ``step()`` multiplexes the engines
        inside one router.  Engines without a cost model price their
        work at zero remaining service (raw deadline ordering)."""
        return min((e.next_slack() for e in self.engines),
                   default=float("inf"))

    @property
    def cost_model(self):
        """A router "has a cost model" (for slack-based multiplexing
        above it) only when every engine behind it does."""
        models = [getattr(e, "cost_model", None) for e in self.engines]
        return models[0] if all(m is not None for m in models) else None

    def cancel(self, rid: int) -> bool:
        engine = self._owner.get(rid)
        return engine.cancel(rid) if engine is not None else False

    # ------------------------------------------- fleet migration hooks
    def evacuate(self, reason: str = "evacuate") -> list:
        """Drain hook for fleet migration: evacuate every engine behind
        the router and forget ownership; returns the mixed-type live
        requests for a surviving replica to ``adopt()``."""
        out: list = []
        for e in self.engines:
            out.extend(e.evacuate(reason))
        for r in out:
            self._owner.pop(r.rid, None)
        return out

    def adopt(self, request: Any) -> ev.RequestHandle:
        """Admit a request evacuated from another replica (see the
        engines' ``adopt()``): dispatched by type like ``submit()`` but
        without the duplicate-rid guard — the rid's prior admission
        lives on the shared bus."""
        engine = self._dispatch(request)
        if engine is None:
            raise ValueError(
                f"no engine for adopted {type(request).__name__}")
        engine.adopt(request)
        self._owner[request.rid] = engine
        return ev.RequestHandle(request.rid, self.bus, self.step,
                                self.cancel, self.has_work)

    def step(self) -> int:
        """Advance the engine with the most urgent pending work by one
        quantum (ties rotate round-robin); returns #requests
        progressed.  Urgency is estimated slack (``next_slack()``)
        when every busy engine has a cost model attached, else the raw
        earliest deadline (``next_deadline()`` — exactly the
        pre-cost-model behavior)."""
        busy = [e for e in self.engines if e.has_work()]
        if not busy:
            return 0
        if all(getattr(e, "cost_model", None) is not None for e in busy):
            keys = [e.next_slack() for e in busy]
        else:
            keys = [e.next_deadline() for e in busy]
        best = min(keys)
        tied = [e for e, k in zip(busy, keys) if k == best]
        engine = tied[self._rr % len(tied)]
        self._rr += 1
        if self.metrics is not None:
            self.metrics.counter(
                "router_steps_total",
                "scheduling quanta granted by the router, per engine",
                labels=("engine",)).inc(
                engine="diffusion" if engine is self.diffusion
                else ("asr" if engine is self.asr else "lm"))
        return engine.step()

    def run(self, max_steps: int = 100_000) -> list:
        """Drain-the-stream compatibility wrapper: returns every
        ``Finished`` payload in completion order (mixed types:
        ``GenerateResult``, LM ``Request``, and ``TranscribeRequest``
        objects)."""
        return [e.result for e in self.stream(max_steps)
                if isinstance(e, ev.Finished)]

    def stream(self, max_steps: int = 100_000) -> Iterator[ev.Event]:
        """Merged event stream over every engine (see
        :class:`~repro_torch.engine.events.EventStreamMixin`)."""
        return super().stream(max_steps)
