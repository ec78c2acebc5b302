"""QoS classes, EDF request queues and engine capability descriptors
(port of the host-side part of ``repro.workload``)."""
from repro_torch.workload.qos import (BEST_EFFORT, DEFAULT_MIX, INTERACTIVE,
                                      STANDARD, QoSClass)

__all__ = ["BEST_EFFORT", "DEFAULT_MIX", "INTERACTIVE", "STANDARD",
           "QoSClass"]
