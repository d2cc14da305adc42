"""Replica fleet serving: one front door over N data-parallel engines
(the port of ``repro.engine.fleet``).

The paper's end goal is energy-efficient *serving* of generative
workloads, and its companion LLM-on-CGLA study evaluates exactly the
multi-unit scale-out axis: many identical accelerator units behind one
host.  :class:`FleetManager` is that host role — it fronts N
data-parallel engine replicas (each a ``DiffusionEngine``, an LM
``ContinuousBatcher``, or an
:class:`~repro_torch.engine.router.EngineRouter` over both,
instantiated in-process from a :class:`ReplicaSpec`) behind
the same ``submit()``/``step()``/``stream()``/``cancel()`` ``Engine``
protocol on ONE shared :class:`~repro_torch.engine.events.EventBus`, so hosts
and benchmarks are replica-count-agnostic: a handle from a fleet pumps
the fleet, a mixed stream stays totally ordered, and the per-rid
lifecycle invariants (one ``Admitted``, one terminal, silence after
terminal) hold fleet-wide.

**Dispatch** is cost-model-balanced: a new request goes to the replica
with the least estimated *completion* time — its live backlog (the sum
of the cost-model estimates captured when each outstanding request was
placed) plus the new request's own estimate from that replica's
:class:`~repro_torch.engine.costmodel.CostModel`.  When any candidate lacks
a model (``cost_model=None``), placement falls back to
least-outstanding-requests.  Ties rotate round-robin.

**Health** is per-replica, driven by the step-latency
:class:`~repro_torch.distributed.fault_tolerance.Watchdog` through the
:class:`~repro_torch.distributed.fault_tolerance.ReplicaHealth` state
machine (HEALTHY -> SUSPECT -> EVICTED, plus DRAINING for planned
removal via :meth:`FleetManager.drain`).  Every ``step()`` the fleet
advances the most urgent busy replica (earliest ``next_deadline()``,
or least ``next_slack()`` when every busy replica carries cost
models — the same multiplex rule ``EngineRouter`` applies to its
engines), measures the quantum on the shared bus clock, and feeds the
replica's watchdog.  A replica whose step *raises*
:class:`ReplicaFault` is evicted immediately.

**Eviction migrates, never drops**: the dead replica's live requests
are pulled out host-side (``evacuate()`` — ``Preempted`` for running
ones, nothing for queued ones) and re-placed on surviving replicas via
``adopt()``, which re-enters them through the engines' bit-exact
resume paths: an LM request re-prefills prompt + generated-so-far
(the preemption contract, now across engine instances) and a
diffusion request simply reruns from its seed (the seed alone
determines the initial latent, so a restart in the same batch bucket is
bit-identical to an uninterrupted run).  Re-admission emits ``Progress(phase="resume")``,
never a second ``Admitted``, and never double-runs a request.

**Replacement (opt-in)**: with ``replace_evicted=True`` an eviction
(except a planned ``drain``) immediately rebuilds a fresh replica from
the evicted slot's :class:`ReplicaSpec` — new engine, new health state
machine, a ``~N``-suffixed name for uniqueness — *before* migration,
so the evacuated requests can land on the replacement and fleet
capacity recovers instead of decaying toward zero across faults
(``stats()["replacements"]`` records each respawn).

**Fault injection** is deterministic and test-facing:
:class:`FaultInjector` kills (raise at the replica's K-th quantum),
hangs (infinite observed step time from quantum K on), or slows
(fixed extra seconds per quantum) a named replica, keyed on the
replica's own step counter so runs replay exactly.

**Shared weights**: a spec's ``params`` may be one tensor tree for
every replica.  Building a replica moves the tree to its device, which
returns tensors already there as they are, so bf16 replicas share the
weights and each owns only its caches (a ``weight_quant`` preset makes
each replica its own quantized copy, as in the reference).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

from repro_torch.distributed.fault_tolerance import (DRAINING, EVICTED,
                                                     ReplicaHealth, Watchdog)
from repro_torch.engine import events as ev
from repro_torch.engine.api import GenerateRequest, is_transcribe
from repro_torch.engine.asr_engine import AsrEngine
from repro_torch.engine.diffusion_engine import DiffusionEngine
from repro_torch.engine.router import EngineRouter


class ReplicaFault(RuntimeError):
    """A replica's step died (injected or real): the fleet evicts the
    replica and migrates its live requests to survivors."""


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Recipe for one in-process replica.  ``name`` keys health, stats,
    and fault plans.

    A spec is declarative: (name, params source, one
    :class:`~repro_torch.engine.config.EngineConfig`) — ``params`` is
    the weight tree or a zero-arg callable returning one (lazy load per
    replica), ``model_cfg`` the model config, ``engine`` the kind
    (``"lm"`` | ``"asr"`` | ``"diffusion"``), ``config`` the shared
    engine config
    (a single instance may back every replica: replicas then share its
    cost model / metrics registry, while each still owns its cache and
    bus — the fleet rebinds the bus before any event is emitted), and
    ``device`` the engine's device.  A ``build`` closure wins when
    set."""
    name: str
    build: Callable[[], Any] | None = None
    params: Any = None
    model_cfg: Any = None
    engine: str = "lm"
    config: Any = None          # engine.config.EngineConfig | None
    device: Any = "cuda"

    def make(self) -> Any:
        """Construct this replica's engine."""
        if self.build is not None:
            return self.build()
        if self.params is None or self.model_cfg is None:
            raise ValueError(
                f"replica {self.name!r} needs either build= or "
                "(params, model_cfg[, config])")
        from repro_torch.engine.config import build_engine
        params = self.params() if callable(self.params) else self.params
        return build_engine(self.engine, params, self.model_cfg,
                            self.config, device=self.device)


class FaultInjector:
    """Deterministic fault plan, keyed on (replica name, that
    replica's own quantum index K) so a run replays exactly:

    * ``kill(name, at_step)`` — the K-th quantum raises
      :class:`ReplicaFault` before the engine runs (a crashed unit);
    * ``hang(name, at_step)`` — quanta >= K observe infinite duration
      (a wedged unit: the watchdog escalates SUSPECT -> EVICTED);
    * ``slow(name, at_step, extra_s, for_steps)`` — quanta in
      [K, K+for_steps) observe ``extra_s`` additional seconds (a
      straggler: one SUSPECT mark, recovering if the window ends).
    """

    def __init__(self):
        self._kill: dict[str, int] = {}
        self._hang: dict[str, int] = {}
        self._slow: dict[str, tuple[int, float, int | None]] = {}

    def kill(self, name: str, at_step: int) -> "FaultInjector":
        self._kill[name] = at_step
        return self

    def hang(self, name: str, at_step: int) -> "FaultInjector":
        self._hang[name] = at_step
        return self

    def slow(self, name: str, at_step: int, extra_s: float,
             for_steps: int | None = None) -> "FaultInjector":
        self._slow[name] = (at_step, float(extra_s), for_steps)
        return self

    def check(self, name: str, k: int) -> None:
        """Raise :class:`ReplicaFault` if ``name`` is scheduled to die
        at its quantum ``k``."""
        if self._kill.get(name) == k:
            raise ReplicaFault(f"injected kill of {name} at step {k}")

    def extra_s(self, name: str, k: int) -> float:
        """Synthetic extra duration observed for quantum ``k``."""
        if name in self._hang and k >= self._hang[name]:
            return float("inf")
        if name in self._slow:
            start, extra, width = self._slow[name]
            if k >= start and (width is None or k < start + width):
                return extra
        return 0.0


@dataclasses.dataclass
class _Replica:
    spec: ReplicaSpec
    engine: Any
    health: ReplicaHealth
    steps: int = 0            # quanta this replica has run (busy only)
    evicted: bool = False     # eviction (incl. migration) already ran


class FleetManager(ev.EventStreamMixin):
    """N data-parallel replicas behind one streaming Engine surface."""

    def __init__(self, specs: list[ReplicaSpec], *,
                 clock: Callable[[], float] = time.monotonic,
                 injector: FaultInjector | None = None,
                 watchdog_threshold: float = 3.0,
                 watchdog_alpha: float = 0.2,
                 suspect_limit: int = 2,
                 replace_evicted: bool = False,
                 metrics=None):
        if not specs:
            raise ValueError("fleet needs at least one replica")
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("replica names must be unique")
        self.bus = ev.EventBus(clock)
        self.injector = injector
        self.metrics = metrics          # None -> no instrumentation
        self.replace_evicted = replace_evicted
        self._wd_params = (watchdog_threshold, watchdog_alpha,
                           suspect_limit)
        self.replicas: list[_Replica] = []
        for spec in specs:
            self._spawn(spec)
        self._owner: dict[int, _Replica] = {}     # rid -> replica
        self._est: dict[int, float] = {}          # rid -> placed estimate
        self._rr_place = 0                        # placement tie rotation
        self._rr_step = 0                         # urgency tie rotation
        self.migrations = 0
        self.evictions: list[tuple[str, str]] = []
        self.replacements: list[tuple[str, str]] = []  # evicted -> fresh
        self._respawns = 0
        self.lost: list[int] = []     # rids with no survivor to adopt them

    def _spawn(self, spec: ReplicaSpec) -> _Replica:
        """Build one replica from its spec, rebind it onto the shared
        bus, and register it with a fresh health state machine."""
        threshold, alpha, suspect_limit = self._wd_params
        engine = spec.make()
        self._rebind(engine)
        rep = _Replica(
            spec, engine,
            ReplicaHealth(Watchdog(threshold=threshold, alpha=alpha),
                          suspect_limit=suspect_limit,
                          name=spec.name, metrics=self.metrics))
        self.replicas.append(rep)
        return rep

    def _rebind(self, engine: Any) -> None:
        """Move a replica (and, for a router, the engines behind it)
        onto the fleet's shared bus — one clock, one total order."""
        for e in [engine] + list(getattr(engine, "engines", [])):
            if e.bus.log:
                raise ValueError(
                    "replica engines must join the fleet before "
                    "emitting events (buses are rebound to a shared one)")
            e.bus = self.bus

    # ---------------------------------------------------------- dispatch
    @staticmethod
    def _serving_engine(engine: Any, request: Any) -> Any:
        """The concrete engine inside ``engine`` that would serve
        ``request`` (None if the replica cannot take this type)."""
        if isinstance(engine, EngineRouter):
            if isinstance(request, GenerateRequest):
                return engine.diffusion
            if is_transcribe(request):
                return engine.asr
            return engine.lm
        if isinstance(request, GenerateRequest):
            return engine if isinstance(engine, DiffusionEngine) else None
        if is_transcribe(request):
            return engine if isinstance(engine, AsrEngine) else None
        return (None if isinstance(engine, (DiffusionEngine, AsrEngine))
                else engine)

    def _estimate(self, rep: _Replica, request: Any) -> float | None:
        sub = self._serving_engine(rep.engine, request)
        cm = getattr(sub, "cost_model", None)
        return None if cm is None else cm.estimate(sub, request)

    def _gc(self) -> None:
        """Forget terminal rids so backlog sums stay O(live)."""
        dead = [rid for rid in self._owner
                if self.bus.terminal(rid) is not None]
        for rid in dead:
            self._owner.pop(rid, None)
            self._est.pop(rid, None)

    def _outstanding(self, rep: _Replica) -> int:
        return sum(1 for rid, r in self._owner.items() if r is rep)

    def _backlog_s(self, rep: _Replica) -> float:
        return sum(self._est.get(rid, 0.0)
                   for rid, r in self._owner.items() if r is rep)

    def _place(self, cands: list[_Replica],
               request: Any) -> tuple[_Replica, float | None]:
        """Least-estimated-completion-time placement: backlog + the
        request's own estimate on each candidate; falls back to
        least-outstanding when any candidate cannot price the request
        (no cost model, or a never-observed phase).  Ties rotate."""
        self._gc()
        ests = [self._estimate(r, request) for r in cands]
        if all(e is not None for e in ests):
            keys = [self._backlog_s(r) + e for r, e in zip(cands, ests)]
        else:
            keys = [float(self._outstanding(r)) for r in cands]
        best = min(keys)
        tied = [i for i, k in enumerate(keys) if k == best]
        i = tied[self._rr_place % len(tied)]
        self._rr_place += 1
        return cands[i], ests[i]

    def _dispatchable(self, request: Any) -> list[_Replica]:
        return [r for r in self.replicas if r.health.dispatchable
                and self._serving_engine(r.engine, request) is not None]

    # --------------------------------------------------------------- API
    def submit(self, request: Any) -> ev.RequestHandle:
        rid = request.rid
        if rid in self._owner or self.bus.admitted(rid) \
                or self.bus.terminal(rid) is not None:
            raise ValueError(f"duplicate rid {rid} across fleet")
        cands = self._dispatchable(request)
        if not cands:
            raise RuntimeError(
                f"no dispatchable replica accepts "
                f"{type(request).__name__} "
                f"(states: {[r.health.state for r in self.replicas]})")
        rep, est = self._place(cands, request)
        rep.engine.submit(request)
        self._owner[rid] = rep
        if self.metrics is not None:
            self.metrics.counter(
                "fleet_dispatch_total",
                "requests placed per replica",
                labels=("replica",)).inc(replica=rep.spec.name)
        # A submit-time Rejected is terminal already: no backlog entry.
        if est is not None and self.bus.terminal(rid) is None:
            self._est[rid] = est
        return ev.RequestHandle(rid, self.bus, self.step, self.cancel,
                                self.has_work)

    def cancel(self, rid: int) -> bool:
        rep = self._owner.get(rid)
        return rep.engine.cancel(rid) if rep is not None else False

    def has_work(self) -> bool:
        return any(r.engine.has_work() for r in self.replicas
                   if r.health.live)

    def next_deadline(self) -> float:
        return min((r.engine.next_deadline() for r in self.replicas
                    if r.health.live), default=float("inf"))

    @property
    def cost_model(self):
        """The fleet "has a cost model" (e.g. for ``calibrate()``)
        only when every live replica does; typically one shared
        :class:`~repro_torch.engine.costmodel.CostModel` instance, so any
        replica's observations refine every replica's estimates."""
        models = [getattr(r.engine, "cost_model", None)
                  for r in self.replicas if r.health.live]
        return (models[0] if models and all(m is not None for m in models)
                else None)

    def drain(self, name: str) -> None:
        """Planned removal: stop dispatching to ``name``; its in-flight
        work runs to completion, then the replica retires (EVICTED with
        reason "drained", zero migrations)."""
        self._by_name(name).health.drain()

    def _by_name(self, name: str) -> _Replica:
        for r in self.replicas:
            if r.spec.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    def step(self) -> int:
        """Advance the most urgent busy replica by one quantum,
        watching its step latency; returns #requests progressed.
        Urgency is least estimated slack when every busy replica
        carries cost models, else earliest deadline (ties rotate) —
        the same rule ``EngineRouter.step()`` applies one level down.
        """
        # Retire replicas that finished draining (even while idle).
        for r in self.replicas:
            if r.health.state == DRAINING and not r.engine.has_work():
                self._evict(r, "drained")
        busy = [r for r in self.replicas
                if r.health.live and r.engine.has_work()]
        if not busy:
            return 0
        if all(getattr(r.engine, "cost_model", None) is not None
               for r in busy):
            keys = [r.engine.next_slack() for r in busy]
        else:
            keys = [r.engine.next_deadline() for r in busy]
        best = min(keys)
        tied = [r for r, k in zip(busy, keys) if k == best]
        rep = tied[self._rr_step % len(tied)]
        self._rr_step += 1
        k = rep.steps
        try:
            if self.injector is not None:
                self.injector.check(rep.spec.name, k)
            t0 = self.bus.clock()
            n = rep.engine.step()
            dt = self.bus.clock() - t0
        except ReplicaFault as fault:
            self._evict(rep, str(fault))
            return 0
        rep.steps += 1
        extra = (self.injector.extra_s(rep.spec.name, k)
                 if self.injector is not None else 0.0)
        if rep.health.observe_step(k, dt + extra) == EVICTED:
            self._evict(rep, rep.health.reason)
        return n

    # ---------------------------------------------------------- eviction
    def _evict(self, rep: _Replica, reason: str) -> None:
        """Evict ``rep`` and migrate every live request it held to
        surviving replicas (bit-exact resume; ``Progress(resume)`` at
        re-admission, never a second ``Admitted``).  Idempotent."""
        if rep.evicted:
            return
        rep.evicted = True
        rep.health.evict(reason)
        self.evictions.append((rep.spec.name, reason))
        if self.metrics is not None:
            self.metrics.counter(
                "fleet_evictions_total", "replica evictions",
                labels=("replica",)).inc(replica=rep.spec.name)
        if self.replace_evicted and reason != "drained":
            # Capacity self-healing: rebuild a fresh replica from the
            # evicted slot's spec (new params/cache/health, suffixed
            # name for uniqueness) BEFORE migrating, so the evacuated
            # requests can land on the replacement too.  Drained
            # replicas are deliberate removals and are not replaced.
            fresh = dataclasses.replace(
                rep.spec, name=f"{rep.spec.name}~{self._respawns}")
            self._respawns += 1
            self._spawn(fresh)
            self.replacements.append((rep.spec.name, fresh.name))
            if self.metrics is not None:
                self.metrics.counter(
                    "fleet_replacements_total",
                    "fresh replicas spawned after evictions",
                    labels=("replica",)).inc(replica=fresh.name)
        moved = rep.engine.evacuate("replica-evicted")
        for req in moved:
            cands = self._dispatchable(req)
            if not cands:
                # No survivor can take it: terminal Cancelled so the
                # handle resolves instead of spinning forever.
                self.lost.append(req.rid)
                self.bus.emit(ev.Cancelled, req.rid)
                self._owner.pop(req.rid, None)
                self._est.pop(req.rid, None)
                if self.metrics is not None:
                    self.metrics.counter(
                        "fleet_lost_total",
                        "requests with no survivor to adopt them").inc()
                continue
            target, est = self._place(cands, req)
            target.engine.adopt(req)
            self._owner[req.rid] = target
            if est is not None:
                self._est[req.rid] = est
            self.migrations += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "fleet_migrations_total",
                    "requests migrated off evicted replicas").inc()

    # ------------------------------------------------------------- drain
    def run(self, max_steps: int = 100_000) -> list:
        """Drain-the-stream compatibility wrapper: every ``Finished``
        payload in completion order (mixed types across replicas)."""
        return [e.result for e in self.stream(max_steps)
                if isinstance(e, ev.Finished)]

    def stream(self, max_steps: int = 100_000) -> Iterator[ev.Event]:
        return super().stream(max_steps)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Fleet observability: per-replica health/quanta/outstanding
        plus migration and eviction counters."""
        self._gc()
        return {
            "replicas": [{
                "name": r.spec.name,
                "state": r.health.state,
                "steps": r.steps,
                "outstanding": self._outstanding(r),
                "suspects": len(r.health.watchdog.suspects),
            } for r in self.replicas],
            "migrations": self.migrations,
            "evictions": list(self.evictions),
            "replacements": list(self.replacements),
            "lost": list(self.lost),
        }
