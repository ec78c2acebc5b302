"""Heterogeneous trace generation: a QoS mix over the Poisson process.

Port of ``repro/workload/trace.py``: a thin front-end over
:func:`repro_torch.cluster.request.poisson_trace`, where the mixing
itself lives (``qos_mix=``).  The trace-level ``max_new_tokens`` bound is
the largest class z_n, and per-class prompt lengths pass through the
classes unchanged.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.cluster.request import Request, poisson_trace
from repro_torch.workload.qos import DEFAULT_MIX, QoSClass


def qos_poisson_trace(num_requests: int, rate: float, prompt_len: int,
                      vocab_size: int, *,
                      mix: Sequence[Tuple[QoSClass, float]] = DEFAULT_MIX,
                      num_origins: int = 1, num_codebooks: int = 0,
                      seed: int = 0) -> List[Request]:
    """Poisson arrivals with per-request class, deadline and demand."""
    z_hi = max(c.z_range[1] for c, _ in mix)
    return poisson_trace(num_requests, rate, prompt_len,
                         max_new_tokens=z_hi, vocab_size=vocab_size,
                         num_origins=num_origins,
                         num_codebooks=num_codebooks, seed=seed,
                         qos_mix=tuple(mix))
