"""Benchmarks of the port (``python -m repro_torch.bench <name>``).

``serving.bench_closed_loop`` mirrors ``benchmarks/serving.py``'s closed
loop: LAD-TS trained in the QoS simulator against six baselines, in the
simulator and on a heterogeneous live fleet.  ``serving.bench_chaos``
mirrors its chaos run (one mid-trace crash and recovery per scheduler,
and the fault-enabled simulator), ``stress.bench_stress``
``benchmarks/stress.py``'s saturation ramp with the overlap A/B.
"""
