"""Fault process for the simulator's episode loop.

Port of ``repro/faults/simfault.py``.  Each edge server is an independent
Bernoulli up/down chain, one transition per time slot:

    up   -> down  w.p. ``p_down``
    down -> up    w.p. ``p_up``

DOWN servers stop draining their queues (Eqn 4's ``f`` term is gated), the
observation grows a per-ES availability column, and actions landing on a
DOWN server are remapped to the least-loaded available one with
``penalty_s`` added to the task's delay.  ``fault=None`` in ``EnvParams``
keeps every code path identical to the fault-free environment.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FaultParams:
    """Bernoulli up/down process + wrong-choice penalty for the sim."""

    p_down: float = 0.05      # per-slot P(healthy -> down)
    p_up: float = 0.5         # per-slot P(down -> recovered)
    penalty_s: float = 2.0    # delay added when the pick was DOWN

    def __post_init__(self):
        if not (0.0 <= self.p_down <= 1.0 and 0.0 < self.p_up <= 1.0):
            raise ValueError("p_down in [0,1] and p_up in (0,1] required")
        if self.penalty_s < 0:
            raise ValueError("penalty_s must be non-negative")

    @property
    def stationary_availability(self) -> float:
        return self.p_up / max(self.p_up + self.p_down, 1e-12)


def init_avail(num_bs: int, device=None) -> torch.Tensor:
    """Every ES starts an episode healthy."""
    return torch.ones((num_bs,), dtype=torch.float32, device=device)


def step_avail(fp: FaultParams, avail: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """One Bernoulli up/down transition per ES (``u``: (B,) uniforms)."""
    up = avail > 0.5
    go_down = up & (u < fp.p_down)
    go_up = ~up & (u < fp.p_up)
    return torch.where(go_down, torch.zeros_like(avail),
                       torch.where(go_up, torch.ones_like(avail), avail))


def mask_actions(avail: torch.Tensor, load: torch.Tensor,
                 actions: torch.Tensor):
    """Remap picks landing on DOWN servers to the least-loaded UP one.

    Returns ``(actions, wrong)`` where ``wrong`` flags the remapped picks.
    When every server is down, picks stand unpenalised.  Runs on the
    device without a host sync."""
    up = avail > 0.5
    any_up = up.any()
    fallback = torch.argmin(torch.where(up, load,
                                        torch.full_like(load, float("inf"))))
    wrong = (~up[actions]) & any_up
    return torch.where(wrong, fallback.to(actions.dtype), actions), wrong
