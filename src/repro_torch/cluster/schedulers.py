"""Pluggable edge-cluster schedulers: one interface, two backends.

Port of ``repro/cluster/schedulers.py``.  A :class:`Scheduler` maps
observation rows ``s = [d_n, w_n, q_1..q_E]`` (normalised) to
target-engine indices over an explicit ``carry``, so one scheduler object
drives either the simulator's episode loop (``cluster/simulate.py`` calls
``select`` for the B base stations) or the live cluster
(``cluster/live.py`` calls ``select_one`` per arriving request).  Rows are
f32 tensors and the randomness is a ``torch.Generator`` passed in by the
caller, where the reference takes a JAX key.

``PolicyScheduler`` wraps trained LAD-TS / D2SAC-TS / SAC-TS / DQN-TS
agent states from ``repro_torch.core.trainer``; the rest are the
non-learned baselines.  The deadline, failure-aware and prefix-affinity
baselines come with their slice (ROADMAP.md A4).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import agents as ag
from repro_torch.core.optim import tree_map
from repro_torch.core.trainer import LEARNED, make_agent_fns

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
        return ((carry + torch.arange(B, device=s.device))
                % self.num_engines, carry + B)


class RandomScheduler(Scheduler):
    name = "random"

    def select(self, carry, s, n, generator):
        return torch.randint(0, self.num_engines, (s.shape[0],),
                             generator=generator,
                             device=generator.device).to(s.device), carry


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
        return (torch.arange(s.shape[0], device=s.device)
                % self.num_engines, carry)

    def select_one(self, carry, s_row, origin, n, generator):
        return int(origin) % self.num_engines, carry


def _infer_state_dim(states) -> Optional[int]:
    """Observation width a stacked agent state was trained on (the input
    width of the first critic/Q layer)."""
    for attr in ("c1", "q"):
        net = getattr(states, attr, None)
        if net is not None:
            return int(net[0]["w"].shape[-2])
    return None


class PolicyScheduler(Scheduler):
    """Trained agents behind the Scheduler interface.

    ``states`` is the stacked agent state from
    ``repro_torch.core.trainer.train_method``: one agent per origin BS.
    ``select`` decides for every origin with its own agent in one call
    (for LAD-TS one fused-chain kernel launch); ``select_one`` runs only
    the origin's agent.  The latent action store (LAD-TS) keeps evolving
    in the carry, so serving decisions keep self-conditioning the chain.
    Draws come from the caller's generator and move to the agents'
    device."""

    def __init__(self, method: str, cfg: ag.AgentConfig, states,
                 num_engines: int, n_max: int):
        if method not in LEARNED:
            raise ValueError(f"{method!r} is not a learned method")
        super().__init__(num_engines)
        self.name = method
        self.method = method
        self.cfg = cfg
        self.states = states
        self.n_max = int(n_max)
        self.state_dim = _infer_state_dim(states)
        self._fns = make_agent_fns(method, cfg)
        self.device = states.replay.size.device

    def init_carry(self):
        return self.states

    def select(self, carry, s, n, generator):
        noise = tree_map(lambda t: t.to(self.device),
                         self._fns.draw_act(carry, generator))
        a, _, carry = self._fns.act(carry, s.to(self.device),
                                    n % self.n_max, noise=noise)
        return a % self.num_engines, carry

    def select_one(self, carry, s_row, origin, n, generator):
        one = tree_map(lambda t: t[origin:origin + 1], carry)
        a, new = self.select(one, s_row[None, :], n, generator)

        def put(full, old, upd):
            if upd is old:
                return full
            full = full.clone()
            full[origin:origin + 1] = upd
            return full

        return int(a[0]), tree_map(put, carry, one, new)


BASELINES = ("round-robin", "jsq", "random", "local")
_LATER = {"deadline": "A4", "failure-aware": "A4",
          "prefix-affinity": "A4"}


def make_scheduler(name: str, num_engines: int,
                   **policy_kwargs) -> Scheduler:
    """Factory: a baseline by name, or a learned method given
    ``cfg``, ``states`` and ``n_max``."""
    if name == "round-robin":
        return RoundRobinScheduler(num_engines)
    if name == "jsq":
        return JoinShortestQueueScheduler(num_engines)
    if name == "random":
        return RandomScheduler(num_engines)
    if name == "local":
        return LocalOnlyScheduler(num_engines)
    if name in LEARNED:
        return PolicyScheduler(name, num_engines=num_engines,
                               **policy_kwargs)
    if name in _LATER:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md {_LATER[name]})")
    raise ValueError(f"unknown scheduler {name!r}; options: "
                     f"{BASELINES + LEARNED}")
