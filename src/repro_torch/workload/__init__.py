"""QoS classes, QoS traces, EDF request queues and engine capability
descriptors (port of ``repro.workload``).

The classes here are shared verbatim by the ``core.env`` simulator
(``EnvParams.qos_mix``) and live traces (``poisson_trace(qos_mix=...)``),
which keeps the extended Eqn-6 observation aligned across both backends.
"""
from repro_torch.workload.capability import (COLD_FLOPS, EngineCapability,
                                             cold_token_seconds)
from repro_torch.workload.qos import (BEST_EFFORT, DEFAULT_MIX, INTERACTIVE,
                                      STANDARD, QoSClass, QoSMix,
                                      normalized_weights, priority_of,
                                      scaled)
from repro_torch.workload.queueing import EDFQueue
from repro_torch.workload.trace import qos_poisson_trace

__all__ = [
    "BEST_EFFORT", "COLD_FLOPS", "DEFAULT_MIX", "EDFQueue",
    "EngineCapability", "INTERACTIVE", "QoSClass", "QoSMix", "STANDARD",
    "cold_token_seconds", "normalized_weights", "priority_of",
    "qos_poisson_trace", "scaled",
]
