"""Benchmarks of the port (``python -m repro_torch.bench``, the
counterpart of ``benchmarks/run.py``).

``serving.bench_tablev`` is the paper's Table V, ``scheduling`` its
Figs. 5-8 in the simulator; ``serving.bench_closed_loop``,
``serving.bench_chaos`` and ``stress.bench_stress`` mirror the
reference's systems benches (the closed loop on a heterogeneous live
fleet, one mid-trace crash and recovery per scheduler, the saturation
ramp with the overlap A/B); ``kernels.bench_kernels`` holds the four
kernels to their plain versions, and ``roofline.bench_roofline`` reads
the dry run's records.
"""
