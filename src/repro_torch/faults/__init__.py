"""Fault injection, health states and the retry/recovery policy (port of
``repro.faults``).

  * ``policy``   — engine ``Health`` states (HEALTHY/DEGRADED/DOWN) and
                   the :class:`RetryPolicy` (capped retries, exponential
                   backoff, per-request watchdog).
  * ``injector`` — deterministic-per-seed live fault schedules
                   (:class:`FaultInjector`: crash / stall / slowdown /
                   recover events on a cluster-relative clock).
  * ``simfault`` — the simulator twin: a per-ES Bernoulli up/down chain
                   (:class:`FaultParams`) with action masking and a
                   wrong-choice penalty inside the episode loop.
"""
from repro_torch.faults.injector import (FaultEvent, FaultInjector,
                                         FaultSpec, single_crash)
from repro_torch.faults.policy import AVAILABILITY, Health, RetryPolicy
from repro_torch.faults.simfault import (FaultParams, init_avail,
                                         mask_actions, step_avail)

__all__ = [
    "AVAILABILITY", "FaultEvent", "FaultInjector", "FaultParams",
    "FaultSpec", "Health", "RetryPolicy", "init_avail", "mask_actions",
    "single_crash", "step_avail",
]
