"""`repro_torch.obs` — unified telemetry: metrics registry + span tracing
(a copy of ``repro.obs``).

The serving stack (engines, batcher, router, fleet, KV runtime, cost
model) accepts an optional ``metrics=`` object.  With the default
``None`` every instrumentation call is skipped and behaviour is
bit-identical; pass a :class:`Telemetry` (or a bare
:class:`MetricsRegistry`) to light the layer up.

:class:`Telemetry` is the facade the wiring expects:

* bundles a :class:`MetricsRegistry` and an optional
  :class:`TraceRecorder`;
* :meth:`Telemetry.attach` subscribes to an
  :class:`~repro_torch.engine.events.EventBus` and derives event-level
  metrics (``events_total``, ``requests_terminal_total``,
  ``queue_wait_seconds``, token/preview/preemption counters) while
  forwarding every event to the tracer;
* engines call :meth:`Telemetry.request_submitted` (submission is not
  a bus event — the bus invariant is that the first event for a rid is
  its ``Admitted``) and :meth:`Telemetry.phase` (one compute quantum,
  named after the cost-model phase key);
* delegates ``counter`` / ``gauge`` / ``histogram``, so duck-typed
  consumers (``ReplicaHealth``, ``CostModel``) work with either a
  ``Telemetry`` or a bare registry.

Attach to the FINAL bus: ``EngineRouter`` / ``FleetManager`` rebind
engine buses onto a shared one during construction, and subscriptions
live on the bus object itself.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.obs.metrics import (DEFAULT_ERROR_BUCKETS,
                               DEFAULT_TIME_BUCKETS,
                               SNAPSHOT_SCHEMA_VERSION, Counter, Gauge,
                               Histogram, MetricsRegistry)
from repro_torch.obs.trace import Marker, Span, TraceRecorder

TERMINAL_EVENT_NAMES = ("Finished", "Cancelled", "Rejected")

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceRecorder", "Span", "Marker", "Telemetry",
    "DEFAULT_TIME_BUCKETS", "DEFAULT_ERROR_BUCKETS",
    "SNAPSHOT_SCHEMA_VERSION", "TERMINAL_EVENT_NAMES",
]


class Telemetry:
    """Metrics registry + optional trace recorder behind one handle."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: TraceRecorder | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry if registry is not None \
            else MetricsRegistry(clock=clock)
        self.tracer = tracer
        # rid -> (submit ts, engine kind) — queue-wait measurement.
        self._submitted: dict[int, tuple[float, str]] = {}

    # ------------------------------------------------- registry facade
    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self.registry.counter(name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self.registry.gauge(name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        return self.registry.histogram(name, help, labels, buckets)

    # ------------------------------------------------------ bus wiring
    def attach(self, bus: Any) -> "Telemetry":
        """Subscribe to the (final, post-router/fleet) event bus.  One
        subscription covers both the event-derived metrics and the
        tracer — do not additionally call ``tracer.attach``."""
        bus.subscribe(self._on_event)
        return self

    def _on_event(self, ev: Any) -> None:
        t = type(ev).__name__
        self.counter("events_total", "bus events by type",
                     labels=("type",)).inc(type=t)
        if t == "Admitted":
            mark = self._submitted.get(ev.rid)
            if mark is not None:
                self.histogram(
                    "queue_wait_seconds",
                    "submit-to-admission wait", labels=("engine",)
                ).observe(ev.ts - mark[0], engine=mark[1])
        elif t == "TokenDelta":
            self.counter("tokens_emitted_total",
                         "streamed tokens").inc()
        elif t == "PreviewLatent":
            self.counter("previews_total",
                         "progressive latent previews").inc()
        elif t == "Preempted":
            self.counter("preemptions_total",
                         "slot preemptions").inc()
        if t in TERMINAL_EVENT_NAMES:
            kind = self._submitted.get(ev.rid, (0.0, "unknown"))[1]
            self.counter(
                "requests_terminal_total",
                "retired requests by outcome",
                labels=("engine", "outcome")
            ).inc(engine=kind, outcome=t.lower())
        if self.tracer is not None:
            self.tracer.on_event(ev)

    # ------------------------------------------------- engine hooks
    def request_submitted(self, rid: int, engine: str,
                          ts: float) -> None:
        """Called by engines at ``submit()`` time (before admission
        control), so queue-wait and rejected-before-admission requests
        are both visible."""
        self._submitted[rid] = (ts, engine)
        self.counter("requests_submitted_total",
                     "submitted requests by engine",
                     labels=("engine",)).inc(engine=engine)
        if self.tracer is not None:
            self.tracer.note_submit(rid, ts, kind=engine)

    def phase(self, engine: str, phase: str, t0: float, t1: float,
              rids=(), args: dict | None = None) -> None:
        """One compute quantum: observe its duration under the
        cost-model-aligned phase name and hand the span to the
        tracer."""
        self.histogram(
            "phase_seconds", "compute quantum duration by phase "
            "(first observation per shape includes jit compile)",
            labels=("engine", "phase")
        ).observe(t1 - t0, engine=engine, phase=phase)
        if self.tracer is not None:
            self.tracer.phase(engine, phase, t0, t1, rids=rids,
                              args=args)
