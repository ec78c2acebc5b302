"""EDF request queues and engine capability descriptors (port of the
host-side part of ``repro.workload``)."""
