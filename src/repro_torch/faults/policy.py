"""Engine health states.

The port's copy of ``Health`` and ``AVAILABILITY`` from
``repro/faults/policy.py``, which the serving engine imports.  The
retry/watchdog policy and the fault injector come with the fault slice
(ROADMAP.md A4).

``HEALTHY`` serves normally; ``DEGRADED`` still serves but reports 0.5
availability; ``DOWN`` is crashed and must not be placed on.
"""
from __future__ import annotations

import enum


class Health(enum.Enum):
    """Availability state of one serving engine."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DOWN = "down"


# Observation feature per health state (NaN-guarded into [0, 1]).
AVAILABILITY = {Health.HEALTHY: 1.0, Health.DEGRADED: 0.5,
                Health.DOWN: 0.0}
