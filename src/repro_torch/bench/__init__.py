"""Benchmarks of the port (``python -m repro_torch.bench <name>``).

``serving.bench_closed_loop`` mirrors ``benchmarks/serving.py``'s closed
loop: LAD-TS trained in the QoS simulator against six baselines, in the
simulator and on a heterogeneous live fleet.
"""
