"""Engine health states (port of ``repro.faults.policy``)."""
