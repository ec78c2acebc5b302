"""Pluggable edge-cluster schedulers.

Port of the baseline half of ``repro/cluster/schedulers.py``.  A
:class:`Scheduler` maps observation rows ``s = [d_n, w_n, q_1..q_E]``
(normalised) to target-engine indices over an explicit ``carry``.  Rows
are f32 CPU tensors and the randomness is a ``torch.Generator`` passed in
by the caller, where the reference takes a JAX key.

The deadline, failure-aware and prefix-affinity baselines come with
their slice (ROADMAP.md A4), and the trained-policy wrapper with the
LAD-TS slices (A1, A5).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

Carry = Any


class Scheduler:
    """Base: stateless-by-default scheduler over ``num_engines`` targets.

    ``state_dim`` declares the observation width the scheduler was built
    for (``None`` = shape-agnostic); ``EdgeCluster`` validates it.
    """

    name = "base"
    state_dim: Optional[int] = None

    def __init__(self, num_engines: int):
        self.num_engines = num_engines

    def init_carry(self) -> Carry:
        return 0

    def select(self, carry: Carry, s: torch.Tensor, n: int,
               generator: torch.Generator) -> Tuple[torch.Tensor, Carry]:
        """s (B, state_dim) -> ((B,) int64 engine indices, carry)."""
        raise NotImplementedError

    def select_one(self, carry: Carry, s_row: torch.Tensor, origin: int,
                   n: int, generator: torch.Generator) -> Tuple[int, Carry]:
        a, carry = self.select(carry, s_row[None, :], n, generator)
        return int(a[0]), carry

    def select_one_masked(self, carry: Carry, s_row: torch.Tensor,
                          origin: int, n: int, generator: torch.Generator,
                          avail) -> Tuple[int, Carry]:
        """Availability-masked selection for the live cluster: take the
        unmasked pick; if it landed on a DOWN engine, redirect to the
        least-loaded available one (queue features at columns 2:2+E).
        The caller guarantees at least one engine is available."""
        eng, carry = self.select_one(carry, s_row, origin, n, generator)
        avail = np.asarray(avail, bool)
        if avail[eng]:
            return eng, carry
        q = np.asarray(s_row, np.float32)[2:2 + self.num_engines]
        return int(np.argmin(np.where(avail, q, np.inf))), carry


class RoundRobinScheduler(Scheduler):
    name = "round-robin"

    def select(self, carry, s, n, generator):
        B = s.shape[0]
        return (carry + torch.arange(B)) % self.num_engines, carry + B


class RandomScheduler(Scheduler):
    name = "random"

    def select(self, carry, s, n, generator):
        return torch.randint(0, self.num_engines, (s.shape[0],),
                             generator=generator), carry


class JoinShortestQueueScheduler(Scheduler):
    """Pick the engine with the smallest queue feature (obs columns 2:);
    ties go to the lowest index, as with ``jnp.argmin``."""

    name = "jsq"

    def select(self, carry, s, n, generator):
        return torch.argmin(s[:, 2:2 + self.num_engines], dim=-1), carry


class LocalOnlyScheduler(Scheduler):
    """Every BS keeps its tasks (no offloading) — the paper's Local-TS."""

    name = "local"

    def select(self, carry, s, n, generator):
        return torch.arange(s.shape[0]) % self.num_engines, carry

    def select_one(self, carry, s_row, origin, n, generator):
        return int(origin) % self.num_engines, carry


BASELINES = ("round-robin", "jsq", "random", "local")
_LATER = {"deadline": "A4", "failure-aware": "A4",
          "prefix-affinity": "A4", "lad-ts": "A5", "d2sac-ts": "A5",
          "sac-ts": "A5", "dqn-ts": "A5"}


def make_scheduler(name: str, num_engines: int) -> Scheduler:
    """Factory: a baseline by name."""
    if name == "round-robin":
        return RoundRobinScheduler(num_engines)
    if name == "jsq":
        return JoinShortestQueueScheduler(num_engines)
    if name == "random":
        return RandomScheduler(num_engines)
    if name == "local":
        return LocalOnlyScheduler(num_engines)
    if name in _LATER:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md {_LATER[name]})")
    raise ValueError(f"unknown scheduler {name!r}; options: {BASELINES}")
