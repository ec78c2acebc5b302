"""QoS classes for heterogeneous AIGC workloads.

Port of ``repro/workload/qos.py``.  A :class:`QoSClass` carries a
priority weight, a service-delay budget (``math.inf`` = best-effort), the
per-class quality-demand range z_n, and optional prompt-length and model
preferences.  Instances are frozen so they can sit inside the frozen
``EnvParams`` and be shared verbatim by the simulator and a live trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


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


def normalized_weights(mix: Sequence[Tuple[QoSClass, float]]):
    """Class list + probability vector for a (class, weight) mix."""
    classes = [c for c, _ in mix]
    w = [float(x) for _, x in mix]
    tot = sum(w)
    if tot <= 0:
        raise ValueError("qos mix weights must sum to a positive value")
    return classes, [x / tot for x in w]


def priority_of(req) -> float:
    """Priority weight of a request (1.0 when it carries no QoS class)."""
    qos = getattr(req, "qos", None)
    return float(getattr(qos, "priority", 1.0) or 1.0)


def scaled(cls: QoSClass, *, deadline_s: Optional[float] = None,
           z_range: Optional[Tuple[int, int]] = None,
           prompt_len: Optional[int] = None,
           model_pref: Optional[str] = None) -> QoSClass:
    """Benchmark helper: rescale a class to a scenario's time/token scale."""
    kw = {}
    if deadline_s is not None:
        kw["deadline_s"] = deadline_s
    if z_range is not None:
        kw["z_range"] = z_range
    if prompt_len is not None:
        kw["prompt_len"] = prompt_len
    if model_pref is not None:
        kw["model_pref"] = model_pref
    return dataclasses.replace(cls, **kw)
