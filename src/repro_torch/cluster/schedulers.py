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
non-learned baselines, the deadline-aware, failure-aware and
prefix-affinity ones on the QoS-, availability- and prefix-extended rows.
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


class DeadlineAwareScheduler(Scheduler):
    """Earliest-expected-completion placement on the QoS observation.

    Requires the extended row ``[d, w, q_1..q_E, slack, c_1..c_E]``:
    picks the engine minimising backlog + this task's own expected
    compute there (``q_e + c_e``).  Per-request deadline urgency is left
    to the engines' priority/EDF queues."""

    name = "deadline"

    def __init__(self, num_engines: int):
        super().__init__(num_engines)
        self.state_dim = 3 + 2 * num_engines

    def select(self, carry, s, n, generator):
        E = self.num_engines
        return torch.argmin(s[:, 2:2 + E] + s[:, 3 + E:3 + 2 * E],
                            dim=-1), carry


class FailureAwareScheduler(Scheduler):
    """Availability-masked least-work placement on a fault-extended row.

    The row's trailing ``E`` columns are the per-engine availability
    features (1 healthy / 0.5 degraded / 0 down) that
    ``EdgeCluster.observe`` and the fault-enabled ``core.env`` append.
    Placement is JSQ over the available engines, plus this task's
    expected compute there with ``qos=True``; DOWN engines are masked,
    so it never pays the simulator's wrong-choice penalty, and a
    DEGRADED engine's cost is doubled."""

    name = "failure-aware"

    def __init__(self, num_engines: int, qos: bool = False):
        super().__init__(num_engines)
        self.qos = bool(qos)
        base = 3 + 2 * num_engines if qos else 2 + num_engines
        self.state_dim = base + num_engines

    def select(self, carry, s, n, generator):
        E = self.num_engines
        cost = s[:, 2:2 + E]
        if self.qos:
            cost = cost + s[:, 3 + E:3 + 2 * E]
        return torch.argmin(_mask_down(cost, s[:, -E:]), dim=-1), carry


def _mask_down(cost: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Scale each cost by 1 / availability (at least 0.5) and mask DOWN
    engines to +inf.  An all-down row's argmin is 0; the live cluster
    never reaches it (``submit`` refuses on a total outage)."""
    cost = cost / torch.clamp(avail, min=0.5)
    return torch.where(avail > 0.25, cost,
                       torch.full_like(cost, float("inf")))


class PrefixAffinityScheduler(Scheduler):
    """Cache-aware placement: route where the prompt's KV already lives.

    Declares ``prefix_obs = True``, so ``EdgeCluster.observe`` appends a
    trailing per-engine block of expected prefix hits (prompt tokens each
    engine could serve from its prefix cache; dense engines report 0).
    Placement minimises::

        cost_e = q_e [+ c_e with qos=True] - hit_weight * hit_e

    With ``fault=True`` the availability columns (just before the hit
    block) mask DOWN engines as ``failure-aware`` does."""

    name = "prefix-affinity"
    prefix_obs = True

    def __init__(self, num_engines: int, qos: bool = False,
                 fault: bool = False, hit_weight: float = 0.5):
        super().__init__(num_engines)
        self.qos = bool(qos)
        self.fault = bool(fault)
        self.hit_weight = float(hit_weight)
        base = 3 + 2 * num_engines if self.qos else 2 + num_engines
        self.state_dim = (base + (num_engines if self.fault else 0)
                          + num_engines)

    def select(self, carry, s, n, generator):
        E = self.num_engines
        cost = s[:, 2:2 + E]
        if self.qos:
            cost = cost + s[:, 3 + E:3 + 2 * E]
        if self.fault:
            cost = _mask_down(cost, s[:, -2 * E:-E])
        return torch.argmin(cost - self.hit_weight * s[:, -E:],
                            dim=-1), carry


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
    device.  ``greedy`` decides by Eqn (8)'s argmax in place of a sample
    (the draws are taken either way)."""

    def __init__(self, method: str, cfg: ag.AgentConfig, states,
                 num_engines: int, n_max: int, greedy: bool = False):
        if method not in LEARNED:
            raise ValueError(f"{method!r} is not a learned method")
        super().__init__(num_engines)
        self.name = method
        self.method = method
        self.cfg = cfg
        self.states = states
        self.n_max = int(n_max)
        self.greedy = greedy
        self.state_dim = _infer_state_dim(states)
        self._fns = make_agent_fns(method, cfg)
        self.device = states.replay.size.device

    def init_carry(self):
        return self.states

    def select(self, carry, s, n, generator):
        noise = tree_map(lambda t: t.to(self.device),
                         self._fns.draw_act(carry, generator))
        a, _, carry = self._fns.act(carry, s.to(self.device),
                                    n % self.n_max, noise=noise,
                                    greedy=self.greedy)
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


BASELINES = ("round-robin", "jsq", "random", "local", "deadline",
             "failure-aware", "prefix-affinity")


def make_scheduler(name: str, num_engines: int,
                   **policy_kwargs) -> Scheduler:
    """Factory: a baseline by name, or a learned method given
    ``cfg``, ``states`` and ``n_max``.  ``failure-aware`` accepts
    ``qos=``; ``prefix-affinity`` accepts ``qos=``, ``fault=`` and
    ``hit_weight=`` (cache-credit strength)."""
    if name == "round-robin":
        return RoundRobinScheduler(num_engines)
    if name == "jsq":
        return JoinShortestQueueScheduler(num_engines)
    if name == "random":
        return RandomScheduler(num_engines)
    if name == "local":
        return LocalOnlyScheduler(num_engines)
    if name == "deadline":
        return DeadlineAwareScheduler(num_engines)
    if name == "failure-aware":
        return FailureAwareScheduler(num_engines,
                                     qos=policy_kwargs.pop("qos", False))
    if name == "prefix-affinity":
        return PrefixAffinityScheduler(
            num_engines, qos=policy_kwargs.pop("qos", False),
            fault=policy_kwargs.pop("fault", False),
            hit_weight=policy_kwargs.pop("hit_weight", 0.5))
    if name in LEARNED:
        return PolicyScheduler(name, num_engines=num_engines,
                               **policy_kwargs)
    raise ValueError(f"unknown scheduler {name!r}; options: "
                     f"{BASELINES + LEARNED}")
