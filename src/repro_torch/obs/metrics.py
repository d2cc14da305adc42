"""Labeled metrics registry: counters, gauges, fixed-bucket histograms
(a copy of ``repro.obs.metrics``: the same Prometheus text and the same
JSON snapshot schema).

The paper's entire contribution is *measurement* — per-phase kernel
breakdowns (Fig. 11), dtype time splits (Table I) — yet until now the
serving stack could only observe itself through ad-hoc benchmark
scripts and ``stats()`` dicts.  This module is the always-on half of
the observability layer (`repro_torch.obs`): a pure-Python, zero-dependency
metrics registry every serving component can write to when telemetry
is enabled (engines take ``metrics=None`` by default and skip every
instrumentation call — the bit-identical contract).

Design points, deliberately Prometheus-shaped:

* **Three instrument kinds.**  :class:`Counter` (monotonic adds),
  :class:`Gauge` (set/inc/dec to the current value), and
  :class:`Histogram` with *fixed* upper-bound buckets chosen at
  creation — no dynamic rebucketing, so merging/diffing snapshots
  across runs is well-defined.
* **Labels.**  Every instrument declares its label names up front;
  samples are keyed by the label-value tuple.  Unknown or missing
  labels raise immediately (a typo'd label would otherwise silently
  fork a time series).
* **Injectable clock.**  The registry carries the same injectable
  clock discipline as the :class:`~repro_torch.engine.events.EventBus`, so
  virtual-clock tests and benchmarks produce deterministic
  timestamps in snapshots.
* **Two export formats.**  :meth:`MetricsRegistry.to_prometheus`
  emits the text exposition format (``# HELP`` / ``# TYPE`` /
  cumulative ``_bucket{le=...}`` rows), and
  :meth:`MetricsRegistry.snapshot_record` /
  :meth:`MetricsRegistry.write_snapshot` emit the *same versioned
  JSON record schema* as ``benchmarks/common.py`` (schema_version 1,
  ``{bench, name, value, detail}`` entries) so metric snapshots ride
  the existing CI perf-trajectory harness (``compare.py`` diffs them
  run-over-run like any other suite).  ``benchmarks/obs_smoke.py``
  cross-validates a written snapshot against
  ``benchmarks.common.validate_record``.

Everything here is pure host Python: no tensors, no background
threads, O(1) per instrumentation call.
"""
from __future__ import annotations

import json
import platform
import sys
import time
from typing import Callable, Iterable, Mapping

# Default histogram buckets (seconds): spans jit-compile tails down to
# sub-millisecond virtual-clock quanta.
DEFAULT_TIME_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.025,
                        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Relative-error buckets (dimensionless): cost-model estimate-vs-actual.
DEFAULT_ERROR_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                         0.5, 1.0, 2.5)

# The JSON snapshot intentionally shares the benchmark record schema
# (benchmarks/common.py BENCH_SCHEMA_VERSION) so CI's perf-trajectory
# comparator consumes metric snapshots unchanged.
SNAPSHOT_SCHEMA_VERSION = 1


def _label_values(declared: tuple[str, ...],
                  given: Mapping[str, object]) -> tuple[str, ...]:
    if set(given) != set(declared):
        raise ValueError(
            f"labels {sorted(given)} do not match declared "
            f"{sorted(declared)}")
    return tuple(str(given[k]) for k in declared)


def _fmt(v: float) -> str:
    """Compact float formatting for exposition rows (ints stay ints)."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _render_labels(names: tuple[str, ...], values: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = (),
                   sep: str = ",") -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(names, values)]
    pairs += [f'{k}="{_escape(v)}"' for k, v in extra]
    return "{" + sep.join(pairs) + "}" if pairs else ""


class _Instrument:
    """Shared labeled-sample plumbing for the three instrument kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._samples: dict[tuple[str, ...], float] = {}

    def _key(self, labels: Mapping[str, object]) -> tuple[str, ...]:
        return _label_values(self.labels, labels)

    def value(self, **labels) -> float:
        """Current value for one label set (0.0 if never touched)."""
        return self._samples.get(self._key(labels), 0.0)

    def samples(self) -> dict[tuple[str, ...], float]:
        """label-value tuple -> value (exposition / snapshot order)."""
        return dict(self._samples)


class Counter(_Instrument):
    """Monotonically increasing labeled counter."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc "
                             f"{amount}")
        k = self._key(labels)
        self._samples[k] = self._samples.get(k, 0.0) + amount


class Gauge(_Instrument):
    """Labeled gauge: set to the current value of something."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._samples[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        self._samples[k] = self._samples.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Instrument):
    """Fixed-bucket labeled histogram (cumulative on exposition).

    ``buckets`` are the finite upper bounds, strictly increasing; an
    implicit ``+Inf`` bucket tops them off.  Per label set the
    histogram keeps non-cumulative bucket counts plus ``sum`` and
    ``count`` — O(len(buckets)) memory, O(log n) per observe.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and "
                f"strictly increasing, got {bs}")
        self.bucket_bounds = bs
        # label key -> [counts per bucket incl. +Inf]
        self._buckets: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        counts = self._buckets.get(k)
        if counts is None:
            counts = self._buckets[k] = [0] * (len(self.bucket_bounds)
                                               + 1)
            self._sums[k] = 0.0
        lo, hi = 0, len(self.bucket_bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bucket_bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        counts[lo] += 1
        self._sums[k] += float(value)
        self._samples[k] = self._samples.get(k, 0.0) + 1  # count mirror

    def count(self, **labels) -> int:
        return int(self._samples.get(self._key(labels), 0))

    def sum(self, **labels) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def buckets(self, **labels) -> dict[float, int]:
        """Cumulative ``upper_bound -> count`` (Prometheus semantics),
        ``+Inf`` included."""
        counts = self._buckets.get(self._key(labels),
                                   [0] * (len(self.bucket_bounds) + 1))
        out, acc = {}, 0
        for bound, c in zip(self.bucket_bounds + (float("inf"),), counts):
            acc += c
            out[bound] = acc
        return out


class MetricsRegistry:
    """Process-wide instrument registry with get-or-create semantics.

    One registry is typically shared by every engine, the KV runtime,
    the cost model, and the fleet (`repro_torch.obs.Telemetry` bundles it
    with the optional trace recorder).  ``counter`` / ``gauge`` /
    ``histogram`` return the existing instrument when the name is
    already registered — and raise if the kind or label names
    disagree, so two call sites cannot silently fork one metric.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._instruments: dict[str, _Instrument] = {}

    # ------------------------------------------------------ factories
    def _get(self, cls, name: str, help: str, labels: tuple[str, ...],
             **kw) -> _Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, labels, **kw)
            self._instruments[name] = inst
            return inst
        if not isinstance(inst, cls) or inst.labels != labels:
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind} "
                f"with labels {inst.labels}, requested {cls.kind} "
                f"with {labels}")
        return inst

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, tuple(labels),
                         buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        return self._instruments.get(name)

    def instruments(self) -> list[_Instrument]:
        return list(self._instruments.values())

    # ----------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for inst in self._instruments.values():
            if inst.help:
                lines.append(f"# HELP {inst.name} {_escape(inst.help)}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            if isinstance(inst, Histogram):
                for key in inst._buckets:
                    labels = dict(zip(inst.labels, key))
                    for bound, c in inst.buckets(**labels).items():
                        lab = _render_labels(inst.labels, key,
                                             (("le", _fmt(bound)),))
                        lines.append(f"{inst.name}_bucket{lab} {c}")
                    lab = _render_labels(inst.labels, key)
                    lines.append(
                        f"{inst.name}_sum{lab} {_fmt(inst._sums[key])}")
                    lines.append(
                        f"{inst.name}_count{lab} "
                        f"{_fmt(inst._samples[key])}")
            else:
                for key, v in inst.samples().items():
                    lab = _render_labels(inst.labels, key)
                    lines.append(f"{inst.name}{lab} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # ------------------------------------------------- JSON snapshot
    def rows(self) -> list[str]:
        """``name,value,detail`` rows — the exact printed-row format
        ``benchmarks/common.py`` parses into schema entries.  Histogram
        samples expand to ``_count`` and ``_sum`` rows (fixed buckets
        are reconstructible from the exposition format; the trajectory
        comparator only needs scalars)."""
        out: list[str] = []
        for inst in self._instruments.values():
            detail = f"{inst.kind}: {inst.help}" if inst.help \
                else inst.kind
            for key, v in inst.samples().items():
                # ';'-separated label pairs: the row's name field must
                # stay comma-free to survive parse_row's 2-split.
                lab = _render_labels(inst.labels, key, sep=";")
                if isinstance(inst, Histogram):
                    out.append(f"{inst.name}_count{lab},{_fmt(v)},"
                               f"{detail}")
                    out.append(f"{inst.name}_sum{lab},"
                               f"{_fmt(inst._sums[key])},{detail}")
                else:
                    out.append(f"{inst.name}{lab},{_fmt(v)},{detail}")
        return out

    def snapshot_record(self, suite: str = "obs",
                        bench: str = "metrics") -> dict:
        """Versioned JSON record in the ``benchmarks/common.py`` schema
        (schema_version, suite, env, ``{bench, name, value, detail}``
        entries) — what CI uploads as a ``BENCH_<suite>.json``-style
        artifact and ``compare.py`` diffs run-over-run."""
        entries = []
        for row in self.rows():
            name, value, detail = (row.split(",", 2) + [""])[:3]
            entries.append({"bench": bench, "name": name,
                            "value": value, "detail": detail})
        return {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "suite": suite,
            "env": {"python": platform.python_version(),
                    "platform": sys.platform},
            "entries": entries,
        }

    def write_snapshot(self, path: str, suite: str = "obs",
                       bench: str = "metrics") -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot_record(suite, bench), f, indent=1)
            f.write("\n")
