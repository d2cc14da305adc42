"""Replica health for the serving fleet and the elastic training mesh
(``repro.distributed.fault_tolerance``).

* ``Watchdog`` — a per-step latency EWMA; a step longer than
  ``threshold x`` the EWMA is a straggler ("suspect") and calls the
  ``on_straggler`` hook.
* ``ReplicaHealth`` — turns the watchdog's signal into a serving-side
  lifecycle (HEALTHY -> SUSPECT -> EVICTED, plus DRAINING for planned
  removal) that ``repro_torch.engine.fleet.FleetManager`` consumes: one
  straggler step marks a replica SUSPECT, ``suspect_limit`` consecutive
  stragglers (or a hard fault) evict it, a clean step clears suspicion.
  Eviction is terminal.
* ``StepTimer`` — times one step into a ``Watchdog`` on an injectable
  clock.

* ``elastic_mesh`` — the largest (pod, data, model) mesh of a rank list,
  with the reference's arithmetic (a :class:`repro_torch.launch.mesh.Mesh`
  of ranks where the reference builds one of devices).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass
class Watchdog:
    """Per-step latency EWMA + straggler detection hook."""
    threshold: float = 3.0
    alpha: float = 0.2
    on_straggler: Callable[[int, float, float], None] | None = None
    ewma: float | None = None
    suspects: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        suspect = (self.ewma is not None
                   and seconds > self.threshold * self.ewma)
        if suspect:
            self.suspects.append((step, seconds, self.ewma))
            if self.on_straggler:
                self.on_straggler(step, seconds, self.ewma)
        # Don't poison the EWMA with the straggler sample itself.
        if not suspect:
            self.ewma = (seconds if self.ewma is None
                         else (1 - self.alpha) * self.ewma
                         + self.alpha * seconds)
        return suspect


# Replica lifecycle states (see ReplicaHealth).
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DRAINING = "DRAINING"
EVICTED = "EVICTED"


@dataclasses.dataclass
class ReplicaHealth:
    """Watchdog-driven replica lifecycle state machine.

    ``observe_step(step, seconds)`` feeds one step duration through
    the :class:`Watchdog` and advances the state:

    * HEALTHY -> SUSPECT on one straggler step (duration above
      ``threshold x`` the EWMA);
    * SUSPECT -> HEALTHY on a clean step (suspicion is consecutive);
    * SUSPECT -> EVICTED after ``suspect_limit`` consecutive
      straggler steps (a hung replica never produces a clean step, so
      it converges here);
    * any live state -> EVICTED via :meth:`evict` (hard fault:
      the replica's step raised);
    * HEALTHY/SUSPECT -> DRAINING via :meth:`drain` (planned removal:
      finish in-flight work, accept nothing new).  A DRAINING replica
      is still watched and can still be EVICTED.

    EVICTED is terminal — a fleet migrates the replica's in-flight
    requests and never dispatches to it again.
    """
    watchdog: Watchdog = dataclasses.field(default_factory=Watchdog)
    suspect_limit: int = 2
    state: str = HEALTHY
    consecutive_suspects: int = 0
    reason: str = ""
    # Optional telemetry: ``name`` identifies the replica and
    # ``metrics`` is a duck-typed sink (repro_torch.obs.Telemetry or a bare
    # MetricsRegistry) — every state change increments a
    # ``replica_health_transitions_total{replica, src, dst}`` counter.
    name: str = ""
    metrics: object = None

    @property
    def live(self) -> bool:
        return self.state != EVICTED

    @property
    def dispatchable(self) -> bool:
        """Whether new requests may be placed on this replica."""
        return self.state in (HEALTHY, SUSPECT)

    def _set_state(self, new: str) -> None:
        if new == self.state:
            return
        old, self.state = self.state, new
        if self.metrics is not None:
            self.metrics.counter(
                "replica_health_transitions_total",
                "replica health state transitions",
                labels=("replica", "src", "dst"),
            ).inc(replica=self.name, src=old, dst=new)

    def observe_step(self, step: int, seconds: float) -> str:
        if not self.live:
            return self.state
        if self.watchdog.observe(step, seconds):
            self.consecutive_suspects += 1
            if self.consecutive_suspects >= self.suspect_limit:
                self.evict(f"watchdog: {self.consecutive_suspects} "
                           f"consecutive straggler steps "
                           f"(last {seconds:.3f}s vs EWMA "
                           f"{self.watchdog.ewma or 0:.3f}s)")
            elif self.state == HEALTHY:
                self._set_state(SUSPECT)
        else:
            self.consecutive_suspects = 0
            if self.state == SUSPECT:
                self._set_state(HEALTHY)
        return self.state

    def evict(self, reason: str) -> None:
        if self.live:
            self._set_state(EVICTED)
            self.reason = reason

    def drain(self) -> None:
        if self.state in (HEALTHY, SUSPECT):
            self._set_state(DRAINING)


class StepTimer:
    """Context manager timing one step into a :class:`Watchdog`.

    ``clock`` is injectable (default ``time.monotonic``) so fleet
    health telemetry is deterministic under virtual-clock tests — the
    same discipline as :class:`repro_torch.engine.events.EventBus`.
    """

    def __init__(self, watchdog: Watchdog,
                 clock: Callable[[], float] = time.monotonic):
        self.watchdog = watchdog
        self.clock = clock
        self._t0 = None
        self._step = 0

    def __enter__(self):
        self._t0 = self.clock()
        return self

    def __exit__(self, *exc):
        self.watchdog.observe(self._step, self.clock() - self._t0)
        self._step += 1
        return False


def elastic_mesh(ranks=None, *, model_parallel: int = 16,
                 pod_size: int = 256) -> Mesh:
    """Largest valid (pod, data, model) mesh from the live rank set
    (``ranks``; by default every rank of the default process group, or
    rank 0 without one).

    Keeps ``model`` fixed, fills ``data`` with what remains inside a pod
    and ``pod`` with whole live pods, as the reference does.  Like the
    reference it raises (numpy's reshape) when fewer than
    ``model_parallel`` ranks are live: ``data`` is floored at 1 and the
    grid wants ``model_parallel`` ranks."""
    if ranks is None:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = np.asarray(ranks)
    n = ranks.size
    pods = max(n // pod_size, 1)
    per_pod = n // pods
    data = max(per_pod // model_parallel, 1)
    usable = pods * data * model_parallel
    grid = ranks.reshape(-1)[:usable].reshape(pods, data, model_parallel)
    return Mesh(grid, ("pod", "data", "model"))
