"""Engine health states (port of ``repro.faults.policy``) and the
simulator's fault process (port of ``repro.faults.simfault``)."""
from repro_torch.faults.simfault import (FaultParams, init_avail,
                                         mask_actions, step_avail)

__all__ = ["FaultParams", "init_avail", "mask_actions", "step_avail"]
