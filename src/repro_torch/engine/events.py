"""Typed event stream for the serving engines (a copy of
``repro.engine.events``, the streaming API core).

The paper frames both Stable Diffusion and LM decode as *serving*
workloads on one host-driven platform; a host that can only
batch-and-drain (``run()``) cannot stream tokens, show x0 previews,
cancel a request, or enforce latency SLOs.  This module is the shared
lifecycle vocabulary that makes the request observable:

* **Events** — frozen dataclasses emitted by the engines in one
  totally-ordered log per :class:`EventBus` (``seq``) with host
  timestamps (``ts``, from the engine's injectable clock).  The
  taxonomy:

  ========================  ==========================================
  ``Admitted``              request left the wait queue (slot / batch)
  ``TokenDelta``            one generated LM token (``pos`` strictly
                            increasing per rid, resumes included)
  ``PreviewLatent``         diffusion x0-space latent at ``step``
  ``Progress``              phase heartbeat (prefill chunk, denoise
                            step, resume)
  ``Preempted``             evicted back to the wait queue (KV blocks
                            released; resume is bit-exact on the
                            scan-prefill path)
  ``Rejected``              terminal: infeasible under the engine's
                            cost model (estimated service time exceeds
                            the remaining deadline budget) — never
                            admitted to a slot/batch
  ``Cancelled``             terminal: request abandoned, state freed
  ``Finished``              terminal: carries the engine's result
  ========================  ==========================================

* **Invariants** (enforced by :meth:`EventBus.emit`, asserted again by
  the CI streaming smoke): at most one ``Admitted`` per rid
  (re-admission after preemption is a ``Progress(phase="resume")``),
  exactly one terminal event per rid, and no events after a terminal.

* **:class:`RequestHandle`** — what ``submit()`` returns.  Iterating
  ``handle.events()`` *drives* the engine (each exhausted buffer pumps
  one ``step()``) until the request reaches a terminal event;
  ``handle.result()`` drains and returns a typed
  :class:`repro_torch.engine.results.TerminalResult` with a common
  ``outcome``/``stats`` shape; ``handle.cancel()`` routes back to the
  engine.  ``handle.state`` exposes the lifecycle state machine
  (``QUEUED -> ADMITTED/RUNNING -> PREEMPTED -> ... -> FINISHED |
  CANCELLED``, or straight to ``REJECTED`` when the engine's cost
  model deems the request infeasible at submission).

* **:class:`EventStreamMixin`** — gives an engine ``stream()`` (a
  drain-and-step generator over the whole bus) and ``handle()``;
  engines provide ``step()``, ``cancel()`` and ``has_work()``.

Everything here is pure host Python: no tensors, no device state,
so the lifecycle layer is unit-testable without a model.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

# ---------------------------------------------------------------- events


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: ``rid`` it belongs to, engine-clock ``ts`` seconds,
    and the bus-global emission sequence number ``seq``."""
    rid: int
    ts: float
    seq: int


@dataclasses.dataclass(frozen=True)
class Admitted(Event):
    """Request left the wait queue: LM slot index or diffusion batch."""
    slot: int | None = None


@dataclasses.dataclass(frozen=True)
class TokenDelta(Event):
    """One generated token; ``pos`` is the index in the request's
    output sequence (strictly increasing, preemption-proof)."""
    token: int = 0
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class PreviewLatent(Event):
    """Diffusion x0-space working latent after ``step`` of ``total``
    denoise steps.  ``decoded`` marks requests submitted with
    ``preview_decode=True``: ``latent`` then already carries the
    VAE-decoded (H, W, 3) pixel image; otherwise decode it with the
    VAE for a visual preview."""
    step: int = 0
    total: int = 0
    latent: Any = None
    decoded: bool = False


@dataclasses.dataclass(frozen=True)
class Progress(Event):
    """Phase heartbeat: ``phase`` is ``"prefill"`` (one prompt chunk),
    ``"denoise"`` (one diffusion step), ``"encode"`` (one ASR audio
    chunk), or ``"resume"`` (re-admission after preemption)."""
    step: int = 0
    total: int = 0
    phase: str = "decode"


@dataclasses.dataclass(frozen=True)
class Preempted(Event):
    """Evicted back to the wait queue (blocks released); the request
    resumes later via prefill of its prompt + generated tokens."""
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class Cancelled(Event):
    """Terminal: request abandoned; queue entry / slot / blocks freed."""


@dataclasses.dataclass(frozen=True)
class Rejected(Event):
    """Terminal: admission control refused the request — its estimated
    service time (``estimated_s``, from the engine's phase-aware cost
    model) exceeds the remaining deadline budget (``budget_s``), or its
    deadline expired while it waited (``reason``: ``"infeasible"`` |
    ``"expired"``).  A request rejected at submission never occupies a
    slot, batch row, or KV block; the one admitted-then-rejected path
    is a preempted over-budget decode that can no longer meet its
    deadline (``Preempted`` precedes ``Rejected`` in that log).
    ``handle.result()`` returns a ``TerminalResult`` with
    ``outcome == "rejected"`` carrying this ``reason``."""
    estimated_s: float = 0.0
    budget_s: float = 0.0
    reason: str = "infeasible"


@dataclasses.dataclass(frozen=True)
class Finished(Event):
    """Terminal: ``result`` is the engine's finished object
    (``GenerateResult`` for diffusion, ``serving.Request`` for LM)."""
    result: Any = None


TERMINAL_EVENTS = (Cancelled, Rejected, Finished)

# Lifecycle states derived from the event log (handle.state).
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
REJECTED = "REJECTED"


class EventBus:
    """Totally-ordered event log shared by every request of an engine
    (or, once the router is ported, by several
    engines — the router rebinds its engines onto one bus so merged
    streams need no cross-bus ordering)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.log: list[Event] = []
        self._seq = 0
        self._base = 0            # seq of log[0] (prefix compaction)
        self._admitted: set[int] = set()
        self._terminal: dict[int, Event] = {}
        self._subs: list[Callable[[Event], None]] = []

    def subscribe(self, fn: Callable[[Event], None]) -> Callable:
        """Register a synchronous observer called once per emitted
        event, after it is appended to the log (the observability
        layer's tap).  Observers must
        not emit or mutate the bus; subscriptions live on this bus
        object, so attach only after router/fleet bus rebinding."""
        self._subs.append(fn)
        return fn

    def emit(self, cls: type, rid: int, **fields) -> Event:
        """Append one event; enforces the per-rid lifecycle invariants
        (single admission, single terminal, silence after terminal)."""
        if rid in self._terminal:
            raise RuntimeError(
                f"event {cls.__name__} after terminal "
                f"{type(self._terminal[rid]).__name__} for rid={rid}")
        if cls is Admitted:
            if rid in self._admitted:
                raise RuntimeError(f"duplicate Admitted for rid={rid} "
                                   "(re-admission must emit "
                                   "Progress(phase='resume'))")
            self._admitted.add(rid)
        ev = cls(rid=rid, ts=self.clock(), seq=self._seq, **fields)
        self._seq += 1
        if isinstance(ev, TERMINAL_EVENTS):
            self._terminal[rid] = ev
        self.log.append(ev)
        for fn in self._subs:
            fn(ev)
        return ev

    def admitted(self, rid: int) -> bool:
        return rid in self._admitted

    def terminal(self, rid: int) -> Event | None:
        return self._terminal.get(rid)

    def events_for(self, rid: int) -> list[Event]:
        return [e for e in self.log if e.rid == rid]

    def since(self, cursor: int) -> tuple[list[Event], int]:
        """Retained events with ``seq >= cursor`` plus the next cursor
        (consumers track absolute seq so compaction cannot skew them)."""
        lo = max(cursor, self._base)
        return self.log[lo - self._base:], self._seq

    def compact(self) -> int:
        """Drop the longest log *prefix* whose events all belong to
        terminal rids — the payload-bearing history (``PreviewLatent``
        latents, token streams) of finished/cancelled requests.  A
        long-lived server calls this periodically; terminal verdicts
        (and ``Finished`` results) stay available via ``terminal()``.
        Returns the number of events dropped."""
        k = 0
        while k < len(self.log) and self.log[k].rid in self._terminal:
            k += 1
        del self.log[:k]
        self._base += k
        return k


class RequestHandle:
    """Host-side handle for one submitted request.

    ``pump`` is the callable that advances the owning engine by one
    scheduling quantum (``engine.step`` — or ``router.step`` when the
    request was submitted through a router, so a handle consumer keeps
    *all* multiplexed work moving while it waits on its own events).
    """

    def __init__(self, rid: int, bus: EventBus,
                 pump: Callable[[], int],
                 canceller: Callable[[int], bool] | None = None,
                 has_work: Callable[[], bool] | None = None):
        self.rid = rid
        self.bus = bus
        self._pump = pump
        self._canceller = canceller
        self._has_work = has_work
        self._cursor = 0          # absolute bus seq already consumed

    # ------------------------------------------------------------ state
    @property
    def done(self) -> bool:
        return self.bus.terminal(self.rid) is not None

    @property
    def state(self) -> str:
        term = self.bus.terminal(self.rid)
        if term is not None:
            if isinstance(term, Finished):
                return FINISHED
            return REJECTED if isinstance(term, Rejected) else CANCELLED
        last = None
        for e in self.bus.log:
            if e.rid == self.rid and isinstance(
                    e, (Admitted, Progress, Preempted, TokenDelta)):
                last = e
        if last is None:
            return QUEUED
        return PREEMPTED if isinstance(last, Preempted) else RUNNING

    def cancel(self) -> bool:
        if self._canceller is None:
            raise RuntimeError(f"rid={self.rid}: engine has no cancel()")
        return self._canceller(self.rid)

    # ----------------------------------------------------------- stream
    def events(self, max_pumps: int = 100_000) -> Iterator[Event]:
        """Yield this request's events, pumping the engine whenever the
        buffer runs dry, until the terminal event has been yielded."""
        pumps = 0
        while True:
            batch, self._cursor = self.bus.since(self._cursor)
            fresh = [e for e in batch if e.rid == self.rid]
            yield from fresh
            if fresh and isinstance(fresh[-1], TERMINAL_EVENTS):
                return
            if self.done:
                # Terminal already reached but not in this read: it was
                # consumed by an earlier iteration's drain or dropped by
                # bus.compact().  Nothing more will ever arrive.
                return
            before = self.bus._seq
            progressed = self._pump()
            pumps += 1
            if pumps > max_pumps:
                raise RuntimeError(
                    f"rid={self.rid}: no terminal event after "
                    f"{max_pumps} engine steps")
            # Idle means stuck only when the engine really has nothing
            # left: a quantum may legitimately progress 0 requests and
            # emit nothing (e.g. clearing a fully-cancelled batch)
            # while queued work remains for the next pump.
            if progressed == 0 and self.bus._seq == before \
                    and not self.done \
                    and not (self._has_work is not None
                             and self._has_work()):
                raise RuntimeError(
                    f"rid={self.rid}: engine idle but request not "
                    "finished (submitted to a different engine?)")

    def result(self) -> Any:
        """Drive to completion and return the typed terminal result.

        Every observable terminal maps to a
        :class:`repro_torch.engine.results.TerminalResult` subclass with a
        common ``outcome``/``stats`` shape (``LMResult`` /
        ``TranscriptResult`` / ``ImageResult`` for finished requests, a
        bare ``TerminalResult`` for cancellations and rejections).
        ``None`` only when no terminal event can be observed at all
        (evicted by ``bus.compact()`` before the handle saw it)."""
        from repro_torch.engine.results import from_terminal
        term = self.bus.terminal(self.rid)
        if term is None:
            for term in self.events():
                pass
        if term is None or not isinstance(term, TERMINAL_EVENTS):
            return None
        if isinstance(term, Finished):
            return from_terminal(self.rid, "finished", term.result)
        if isinstance(term, Rejected):
            return from_terminal(self.rid, "rejected",
                                 reason=term.reason)
        return from_terminal(self.rid, "cancelled")


class EventStreamMixin:
    """Streaming surface shared by the engines and the router.

    Requires ``self.bus`` (:class:`EventBus`), ``self.step() -> int``
    and ``self.has_work() -> bool``; provides ``stream()`` and
    ``handle()``.
    """

    bus: EventBus

    def stream(self, max_steps: int = 100_000) -> Iterator[Event]:
        """Drain-and-step generator: runs the engine while yielding
        every event in emission order; returns when the engine idles.
        The consumer may call ``cancel()``/``submit()`` mid-iteration:
        the cursor advances past exactly the events yielded, so events
        emitted while the generator is suspended are never skipped."""
        cursor = 0
        for _ in range(max_steps):
            batch, cursor = self.bus.since(cursor)
            yield from batch
            if not self.has_work():
                break
            self.step()                               # type: ignore[attr-defined]
        while cursor < self.bus._seq:
            batch, cursor = self.bus.since(cursor)
            yield from batch

    def handle(self, rid: int) -> RequestHandle:
        return RequestHandle(
            rid, self.bus, self.step,                 # type: ignore[attr-defined]
            getattr(self, "cancel", None), self.has_work)
