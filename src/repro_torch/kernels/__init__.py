"""Hand-written CUDA kernels, their plain versions and the dispatching
wrappers (port of ``repro.kernels``)."""
