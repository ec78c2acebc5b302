"""QoS classes for heterogeneous AIGC workloads.

Port of the class definitions in ``repro/workload/qos.py``.  A
:class:`QoSClass` carries a priority weight, a service-delay budget
(``math.inf`` = best-effort), the per-class quality-demand range z_n, and
optional prompt-length and model preferences.  Instances are frozen so they
can sit inside the frozen ``EnvParams``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One service class of the heterogeneous workload."""

    name: str
    priority: float = 1.0
    deadline_s: float = math.inf      # budget from arrival to finish
    z_range: Tuple[int, int] = (1, 16)
    prompt_len: Optional[int] = None
    model_pref: Optional[str] = None

    def __post_init__(self):
        if self.priority <= 0:
            raise ValueError(f"{self.name}: priority must be positive")
        if self.deadline_s <= 0:
            raise ValueError(f"{self.name}: deadline must be positive")
        lo, hi = self.z_range
        if not (0 < lo <= hi):
            raise ValueError(f"{self.name}: bad z_range {self.z_range}")

    @property
    def best_effort(self) -> bool:
        return math.isinf(self.deadline_s)


# Default three-tier mix (interactive / standard / batch).
INTERACTIVE = QoSClass("interactive", priority=4.0, deadline_s=2.0,
                       z_range=(1, 8))
STANDARD = QoSClass("standard", priority=2.0, deadline_s=6.0,
                    z_range=(4, 16))
BEST_EFFORT = QoSClass("batch", priority=1.0, deadline_s=math.inf,
                       z_range=(8, 32))

# (class, mix weight) pairs; weights are normalised wherever consumed.
QoSMix = Tuple[Tuple[QoSClass, float], ...]
DEFAULT_MIX: QoSMix = ((INTERACTIVE, 0.4), (STANDARD, 0.4),
                       (BEST_EFFORT, 0.2))
