"""Per-request span tracing over the engine event bus (a copy of
``repro.obs.trace``).

:class:`TraceRecorder` is the second half of the observability layer:
where the :class:`~repro_torch.obs.metrics.MetricsRegistry` aggregates, the
recorder keeps *individual* request timelines — the serving-side
analogue of the paper's Fig. 11 per-phase breakdown, reconstructed
per request instead of per benchmark run.

Span sources
------------

1. **Bus events** (:meth:`attach` subscribes to an
   :class:`~repro_torch.engine.events.EventBus`): the recorder derives the
   lifecycle skeleton — a ``queue_wait`` span from the submit mark to
   ``Admitted``, instant markers for ``TokenDelta`` / ``Progress`` /
   ``PreviewLatent`` / ``Preempted``, and the root ``request`` span
   closed by the terminal event (``Finished`` | ``Cancelled`` |
   ``Rejected``), carrying the outcome.
2. **Engine phase marks** (:meth:`phase`, called by instrumented
   engines through ``repro_torch.obs.Telemetry``): exact compute spans per
   scheduling quantum, named after the cost-model phase keys —
   ``clip`` / ``unet_step`` / ``vae`` / ``fused`` for diffusion,
   ``prefill`` / ``decode`` for the LM — one span on the per-engine
   track plus one per participating rid, so a request's tree shows
   exactly the quanta it rode.

Events are classified by *class name*, not ``isinstance``, so this
module stays import-light (no tensors, no engine imports) and works
against any bus whose events carry ``rid`` / ``ts`` / ``seq``.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}`` with
``ph: "X"`` complete spans and ``ph: "i"`` instants, microsecond
timestamps) — loadable in Perfetto / ``chrome://tracing``.  Each rid
gets its own named thread row; each engine phase stream gets a
synthetic high-numbered one.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

TERMINAL_NAMES = ("Finished", "Cancelled", "Rejected")

# Synthetic Chrome tid base for per-engine phase tracks (request rows
# use the rid itself; rids are small ints in this repo).
_ENGINE_TID_BASE = 1_000_000


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval on a request's (or an engine's) timeline."""
    name: str
    cat: str                  # engine kind ("lm"/"diffusion") or "request"
    start: float              # engine-clock seconds
    end: float
    rid: int | None           # None -> engine-track aggregate span
    args: dict | None = None

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Marker:
    """Instant event (Chrome ``ph: "i"``)."""
    name: str
    cat: str
    ts: float
    rid: int
    args: dict | None = None


class TraceRecorder:
    """Assembles per-request span trees from bus events + phase marks.

    Pure host Python, append-only; a long-lived server would rotate
    recorders per export window (the gating smoke uses one per run).
    """

    def __init__(self):
        self.spans: list[Span] = []
        self.markers: list[Marker] = []
        # rid -> {"kind", "submit", "first", "terminal", "outcome"}
        self._req: dict[int, dict] = {}
        self._bus = None

    # ----------------------------------------------------------- wiring
    def attach(self, bus: Any) -> "TraceRecorder":
        """Subscribe to a bus (call AFTER router/fleet construction:
        those rebind engine buses onto a shared one, and a subscription
        lives on the bus object itself)."""
        bus.subscribe(self.on_event)
        self._bus = bus
        return self

    def note_submit(self, rid: int, ts: float,
                    kind: str = "request") -> None:
        """Record a submission mark — the start of the ``queue_wait``
        span and of the root ``request`` span.  Engines call this (via
        ``Telemetry.request_submitted``) because submission is not a
        bus event."""
        self._req[rid] = {"kind": kind, "submit": ts, "first": None,
                          "terminal": None, "outcome": None}

    def _state(self, rid: int) -> dict:
        return self._req.setdefault(
            rid, {"kind": "request", "submit": None, "first": None,
                  "terminal": None, "outcome": None})

    # ----------------------------------------------------------- intake
    def on_event(self, ev: Any) -> None:
        st = self._state(ev.rid)
        if st["first"] is None:
            st["first"] = ev.ts
        kind = st["kind"]
        t = type(ev).__name__
        if t == "Admitted":
            start = st["submit"] if st["submit"] is not None else ev.ts
            self.add_span("queue_wait", start, ev.ts, rid=ev.rid,
                          cat=kind, args={"slot": getattr(ev, "slot",
                                                          None)})
        elif t in TERMINAL_NAMES:
            st["terminal"], st["outcome"] = ev.ts, t.lower()
            start = (st["submit"] if st["submit"] is not None
                     else st["first"])
            self.add_span("request", start, ev.ts, rid=ev.rid, cat=kind,
                          args={"outcome": t.lower()})
        elif t == "TokenDelta":
            self.markers.append(Marker(
                "token", kind, ev.ts, ev.rid,
                {"pos": ev.pos, "token": ev.token}))
        elif t == "Progress":
            self.markers.append(Marker(
                f"progress:{ev.phase}", kind, ev.ts, ev.rid,
                {"step": ev.step, "total": ev.total}))
        elif t == "PreviewLatent":
            self.markers.append(Marker(
                "preview", kind, ev.ts, ev.rid,
                {"step": ev.step, "total": ev.total}))
        elif t == "Preempted":
            self.markers.append(Marker(
                "preempted", kind, ev.ts, ev.rid,
                {"reason": ev.reason}))

    def phase(self, cat: str, name: str, start: float, end: float,
              rids: tuple = (), args: dict | None = None) -> None:
        """One engine compute quantum: an aggregate span on the
        ``cat`` engine track plus one child span per participating
        rid (the per-request tree's phase leaves)."""
        agg = dict(args or {})
        agg["rids"] = list(rids)
        self.add_span(name, start, end, rid=None, cat=cat, args=agg)
        for rid in rids:
            self.add_span(name, start, end, rid=rid, cat=cat, args=args)
            st = self._state(rid)
            if st["kind"] == "request":
                st["kind"] = cat

    def add_span(self, name: str, start: float, end: float, *,
                 rid: int | None = None, cat: str = "engine",
                 args: dict | None = None) -> Span:
        sp = Span(name, cat, start, end, rid, args)
        self.spans.append(sp)
        return sp

    # --------------------------------------------------------- querying
    def request_spans(self, rid: int) -> list[Span]:
        return sorted((s for s in self.spans if s.rid == rid),
                      key=lambda s: (s.start, s.end))

    def request_tree(self, rid: int) -> tuple[Span | None, list[Span]]:
        """(root ``request`` span or None, children sorted by start)."""
        spans = self.request_spans(rid)
        roots = [s for s in spans if s.name == "request"]
        children = [s for s in spans if s.name != "request"]
        return (roots[0] if roots else None), children

    def rids(self) -> list[int]:
        return sorted(self._req)

    def outcome(self, rid: int) -> str | None:
        return self._req.get(rid, {}).get("outcome")

    # ----------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable)."""
        evs: list[dict] = []
        engine_tids: dict[str, int] = {}

        def tid_for(span_cat: str, rid: int | None) -> int:
            if rid is not None:
                return int(rid)
            tid = engine_tids.get(span_cat)
            if tid is None:
                tid = _ENGINE_TID_BASE + len(engine_tids)
                engine_tids[span_cat] = tid
                evs.append({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": tid,
                            "args": {"name": f"engine:{span_cat}"}})
            return tid

        for rid in self.rids():
            evs.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": int(rid),
                        "args": {"name": f"rid {rid} "
                                 f"({self._req[rid]['kind']})"}})
        for s in self.spans:
            evs.append({"name": s.name, "cat": s.cat, "ph": "X",
                        "ts": s.start * 1e6, "dur": s.dur * 1e6,
                        "pid": 0, "tid": tid_for(s.cat, s.rid),
                        "args": s.args or {}})
        for m in self.markers:
            evs.append({"name": m.name, "cat": m.cat, "ph": "i",
                        "s": "t", "ts": m.ts * 1e6, "pid": 0,
                        "tid": int(m.rid), "args": m.args or {}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")
