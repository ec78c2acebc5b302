"""Deterministic per-seed fault schedules for a live edge cluster.

Port of ``repro/faults/injector.py`` (numpy only, so the schedule of a
(spec, seed, horizon) is the reference's bit for bit).

A :class:`FaultInjector` turns a list of :class:`FaultEvent` entries into
the state transitions the cluster applies while it runs: hard crashes
(engine DOWN, in-flight work orphaned), transient stalls (engine frozen
for a window), sustained slowdowns (engine steps at a fraction of its
rate), and recoveries after a downtime window.  Event times are
CLUSTER-RELATIVE seconds — the same timebase as ``Request.arrival_s`` in
a replayed trace — so one schedule means the same thing across runs and
machines.

Schedules are data, not randomness: :meth:`FaultInjector.from_spec`
expands a compact :class:`FaultSpec` into concrete events with
``numpy.random.default_rng(seed)``, so a chaos run is exactly
reproducible given (spec, seed) and two injectors built from the same
spec/seed fire identical schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional

import numpy as np

KINDS = ("crash", "stall", "slowdown", "recover")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault transition on one engine.

    ``duration_s`` auto-schedules the matching recovery (``inf`` = the
    engine never comes back on its own); ``factor`` is the slowdown
    stride — a ``slowdown`` engine serves one step out of ``factor``.
    """

    t_s: float
    engine: int
    kind: str
    duration_s: float = math.inf
    factor: int = 2

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"options: {KINDS}")
        if self.t_s < 0 or self.duration_s <= 0:
            raise ValueError("fault times/durations must be positive")
        if self.factor < 1:
            raise ValueError("slowdown factor must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Compact description of a random chaos schedule.

    Counts are totals across the cluster; times are drawn uniformly in
    ``[0.05, 0.75] * horizon_s`` so faults land mid-trace with room for
    recovery, and crash/slowdown windows last ``downtime_frac`` /
    ``slow_frac`` of the horizon.
    """

    crashes: int = 1
    stalls: int = 0
    slowdowns: int = 0
    downtime_frac: float = 0.25
    stall_frac: float = 0.08
    slow_frac: float = 0.3
    slow_factor: int = 3


class FaultInjector:
    """Replays a fault schedule against a cluster clock.

    The cluster polls :meth:`due` with its run-relative time; each event
    fires exactly once, in time order.  ``reset()`` rewinds the schedule
    so the same injector can replay an identical chaos run for another
    scheduler.
    """

    def __init__(self, events: Iterable[FaultEvent], num_engines: int,
                 seed: Optional[int] = None):
        evs: List[FaultEvent] = []
        for ev in events:
            if not 0 <= ev.engine < num_engines:
                raise ValueError(f"fault event targets engine {ev.engine}; "
                                 f"cluster has {num_engines}")
            evs.append(ev)
            if ev.kind in ("crash", "slowdown") and \
                    math.isfinite(ev.duration_s):
                evs.append(FaultEvent(t_s=ev.t_s + ev.duration_s,
                                      engine=ev.engine, kind="recover"))
        self.num_engines = num_engines
        self.seed = seed
        self.events = sorted(evs, key=lambda e: (e.t_s, e.engine, e.kind))
        self._next = 0

    # ------------------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: FaultSpec, num_engines: int, horizon_s: float,
                  seed: int = 0) -> "FaultInjector":
        """Deterministically expand a spec into a concrete schedule."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []

        def times(n):
            return rng.uniform(0.05 * horizon_s, 0.75 * horizon_s, n)

        for t in times(spec.crashes):
            events.append(FaultEvent(
                t_s=float(t), engine=int(rng.integers(num_engines)),
                kind="crash",
                duration_s=float(spec.downtime_frac * horizon_s)))
        for t in times(spec.stalls):
            events.append(FaultEvent(
                t_s=float(t), engine=int(rng.integers(num_engines)),
                kind="stall",
                duration_s=float(spec.stall_frac * horizon_s)))
        for t in times(spec.slowdowns):
            events.append(FaultEvent(
                t_s=float(t), engine=int(rng.integers(num_engines)),
                kind="slowdown",
                duration_s=float(spec.slow_frac * horizon_s),
                factor=int(spec.slow_factor)))
        return cls(events, num_engines, seed=seed)

    # ------------------------------------------------------------------
    def due(self, now_s: float) -> List[FaultEvent]:
        """Events whose time has come, each returned exactly once."""
        out = []
        while self._next < len(self.events) and \
                self.events[self._next].t_s <= now_s:
            out.append(self.events[self._next])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.events)

    def reset(self) -> None:
        """Rewind so the identical schedule replays from t=0."""
        self._next = 0

    def describe(self) -> List[dict]:
        """JSON-friendly schedule dump (for BENCH_chaos.json records)."""
        return [{"t_s": e.t_s, "engine": e.engine, "kind": e.kind,
                 "duration_s": (None if math.isinf(e.duration_s)
                                else e.duration_s),
                 "factor": e.factor}
                for e in self.events]


def single_crash(engine: int, t_s: float, downtime_s: float,
                 num_engines: int) -> FaultInjector:
    """The canonical chaos case: one hard mid-trace crash + recovery."""
    return FaultInjector(
        [FaultEvent(t_s=t_s, engine=engine, kind="crash",
                    duration_s=downtime_s)], num_engines)
