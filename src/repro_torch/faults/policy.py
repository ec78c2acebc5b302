"""Engine health states and the request retry/watchdog policy.

Port of ``repro/faults/policy.py``.  The cluster reduces every fault to
three health states:

``HEALTHY``
    Serving normally; fully available to the scheduler.
``DEGRADED``
    Alive but impaired (stalling or running slowed).  Still admits and
    serves requests; the availability observation reports 0.5 so a
    failure-aware policy can steer around it without masking it.
``DOWN``
    Crashed.  In-flight lanes were drained, KV pages or dense slots
    reclaimed, and the orphaned requests handed back to the cluster for
    re-offloading.  The scheduler must not place here (availability 0).

:class:`RetryPolicy` holds the recovery knobs: how many placements a
request gets (``max_attempts``), how re-offloads back off
(``backoff_base_s * backoff_factor**(attempts-1)``), and the per-request
watchdog that abandons requests whose deadline is hopeless, so overload
sheds the starving tail instead of collapsing.  Deadline-carrying
requests are abandoned once their elapsed time exceeds
``deadline_grace`` times their budget; best-effort requests get a flat
``best_effort_timeout_s``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Health(enum.Enum):
    """Availability state of one serving engine."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DOWN = "down"


# Observation feature per health state (NaN-guarded into [0, 1]).
AVAILABILITY = {Health.HEALTHY: 1.0, Health.DEGRADED: 0.5,
                Health.DOWN: 0.0}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped-retry + exponential-backoff + watchdog configuration."""

    max_attempts: int = 3            # total placements, first try included
    backoff_base_s: float = 0.05     # wait before the first re-offload
    backoff_factor: float = 2.0      # exponential growth per extra attempt
    deadline_grace: float = 2.0      # abandon past grace * deadline budget
    best_effort_timeout_s: float = 30.0   # watchdog for deadline-free work

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff must be non-negative and "
                             "non-shrinking")
        if self.deadline_grace < 1.0:
            raise ValueError("deadline_grace < 1 would abandon requests "
                             "that could still meet their deadline")

    def backoff_s(self, attempts: int) -> float:
        """Delay before re-offloading a request placed ``attempts`` times."""
        return (self.backoff_base_s
                * self.backoff_factor ** max(attempts - 1, 0))

    def hopeless(self, req, now: float) -> bool:
        """Watchdog verdict: is finishing this request pointless?

        ``now`` is on the same clock as ``req.t_arrival`` (the cluster
        stamps arrivals on first submit, so a retried request is judged
        against its original arrival, not the retry time)."""
        t0 = req.t_arrival if req.t_arrival is not None else req.t_enqueue
        if t0 is None:
            return False
        elapsed = now - t0
        budget: Optional[float] = req.deadline_budget_s
        if budget is not None:
            return elapsed > self.deadline_grace * budget
        return elapsed > self.best_effort_timeout_s
