"""AIGC edge-offloading environment (paper §III, Eqns (1)-(9)).

Port of ``repro/core/env.py``.  B base stations each front an edge server
running an AIGC service.  In every time slot t, N_{b,t} tasks arrive at BS
b and a scheduler assigns each to an ES b'.  A task's service delay
(Eqn 2) is

    T = d_n / v_up  +  rho_n * z_n / f_b'  +  T_wait  +  d~_n / v_down
    T_wait = (q_{t-1,b'} + q_bef) / f_b'                       (Eqn 3)

and per-ES queues evolve by Eqn (4):

    q_t,b' = max(q_{t-1,b'} + sum workloads placed on b' - f_b' * Delta, 0)

Within a slot the n-th tasks of all B stations are decided together
against the queue state built by tasks 1..n-1.  Every function works on
tensors on one device and never syncs with the host; randomness comes
from a ``torch.Generator``.  The QoS (``qos_mix``) and fault (``fault``)
extensions are the reference's, and with both off the environment is the
paper's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

# re-exported so env consumers drive the fault process through envlib
from repro_torch.faults.simfault import (FaultParams, init_avail,  # noqa: F401
                                         mask_actions, step_avail)


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Defaults follow Table III of the paper.

    ``qos_mix`` (``(QoSClass, weight)`` pairs, ``repro_torch.workload``)
    switches on the heterogeneous-QoS extension: per-task service classes,
    the observation ``[d, rho*z, q_1..q_B, slack, rho*z/f_1..rho*z/f_B]``,
    priority-weighted rewards and an optional ``deadline_penalty``.
    ``fault`` (a ``FaultParams``) switches on per-ES Bernoulli up/down
    chains with availability columns appended LAST and remapped picks.
    """

    num_bs: int = 20                 # B
    num_slots: int = 60              # |T|
    slot_seconds: float = 1.0        # Delta
    max_tasks: int = 50              # N_{b,t} ~ U[1, max_tasks]
    min_tasks: int = 1
    d_range: Tuple[float, float] = (2.0, 5.0)        # Mbits
    d_out_range: Tuple[float, float] = (0.6, 1.0)    # Mbits
    z_range: Tuple[float, float] = (1.0, 15.0)       # denoising steps
    rho_range: Tuple[float, float] = (0.1, 0.3)      # Gcycles per step
    v_range: Tuple[float, float] = (400.0, 500.0)    # Mbit/s
    f_range: Tuple[float, float] = (10.0, 50.0)      # Gcycles/s
    # 0.0 = iid tasks, 1.0 = task slot n always carries the same demand
    task_periodicity: float = 0.0
    qos_mix: Tuple[Tuple[Any, float], ...] = ()
    slack_cap: float = 10.0          # seconds; clamps inf deadlines
    deadline_penalty: float = 0.0    # extra -reward per missed deadline
    fault: Optional[FaultParams] = None

    @property
    def has_qos(self) -> bool:
        return len(self.qos_mix) > 0

    @property
    def has_faults(self) -> bool:
        return self.fault is not None

    @property
    def z_hi(self) -> float:
        """Largest quality demand across base range and QoS classes."""
        z = self.z_range[1]
        for c, _ in self.qos_mix:
            z = max(z, c.z_range[1])
        return float(z)

    @property
    def state_dim(self) -> int:
        base = 2 + self.num_bs
        return (base + (1 + self.num_bs if self.has_qos else 0)
                + (self.num_bs if self.has_faults else 0))

    @property
    def action_dim(self) -> int:
        return self.num_bs


class EpisodeData(NamedTuple):
    """Pre-sampled randomness for one episode (shapes lead with T, N, B)."""

    d: torch.Tensor        # (T, N, B) input Mbits
    d_out: torch.Tensor    # (T, N, B) result Mbits
    z: torch.Tensor        # (T, N, B) denoising steps
    rho: torch.Tensor      # (T, N, B) Gcycles per step
    v_up: torch.Tensor     # (T, N, B) Mbit/s
    v_down: torch.Tensor   # (T, N, B) Mbit/s
    mask: torch.Tensor     # (T, N, B) task exists
    f: torch.Tensor        # (B,) ES capacity Gcycles/s
    cls: torch.Tensor      # (T, N, B) class index (0 without QoS)
    deadline: torch.Tensor  # (T, N, B) service budget, inf = best-effort
    priority: torch.Tensor  # (T, N, B) priority weight (1 without QoS)
    avail_u: torch.Tensor  # (T, B) U[0,1) for the up/down chain


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + u * (hi - lo)


def sample_capacities(generator: torch.Generator, p: EnvParams
                      ) -> torch.Tensor:
    """Per-ES compute capacities — hardware, so sampled once per
    environment and held fixed across episodes."""
    return _uniform(generator, (p.num_bs,), *p.f_range)


def sample_episode(generator: torch.Generator, p: EnvParams,
                   f: Optional[torch.Tensor] = None) -> EpisodeData:
    """One episode's tasks on the generator's device."""
    g, dev = generator, generator.device
    shape = (p.num_slots, p.max_tasks, p.num_bs)

    def periodic(lo, hi):
        """Blend a per-(task-slot, BS) base demand with iid noise."""
        iid = _uniform(g, shape, lo, hi)
        if p.task_periodicity <= 0.0:
            return iid
        base = _uniform(g, (1, p.max_tasks, p.num_bs), lo, hi)
        w = p.task_periodicity
        return w * base.expand(shape) + (1 - w) * iid

    n_tasks = torch.randint(p.min_tasks, p.max_tasks + 1,
                            (p.num_slots, p.num_bs), generator=g, device=dev)
    mask = (torch.arange(p.max_tasks, device=dev)[None, :, None]
            < n_tasks[:, None, :]).to(torch.float32)
    if p.has_qos:
        classes = [c for c, _ in p.qos_mix]
        w = torch.tensor([x for _, x in p.qos_mix], dtype=torch.float32)
        cdf = torch.cumsum(w / w.sum(), 0).to(dev)
        u = torch.rand(shape, generator=g, device=dev)
        cls = torch.clamp(torch.searchsorted(cdf, u.reshape(-1),
                                             right=True).reshape(shape),
                          max=len(classes) - 1)

        def per_class(values):
            return torch.tensor(values, dtype=torch.float32,
                                device=dev)[cls]

        z_lo = per_class([c.z_range[0] for c in classes])
        z_hi = per_class([c.z_range[1] for c in classes])
        z = torch.round(z_lo + _uniform(g, shape, 0.0, 1.0) * (z_hi - z_lo))
        deadline = per_class([c.deadline_s if math.isfinite(c.deadline_s)
                              else math.inf for c in classes])
        priority = per_class([c.priority for c in classes])
    else:
        cls = torch.zeros(shape, dtype=torch.int64, device=dev)
        z = torch.round(periodic(*p.z_range))
        deadline = torch.full(shape, math.inf, device=dev)
        priority = torch.ones(shape, device=dev)
    return EpisodeData(
        d=periodic(*p.d_range),
        d_out=_uniform(g, shape, *p.d_out_range),
        z=z,
        rho=periodic(*p.rho_range),
        v_up=_uniform(g, shape, *p.v_range),
        v_down=_uniform(g, shape, *p.v_range),
        mask=mask,
        f=f if f is not None else sample_capacities(g, p),
        cls=cls,
        deadline=deadline,
        priority=priority,
        avail_u=_uniform(g, (p.num_slots, p.num_bs), 0.0, 1.0),
    )


class QueueState(NamedTuple):
    q_prev: torch.Tensor   # (B,) queue length at end of slot t-1 (Gcycles)
    q_bef: torch.Tensor    # (B,) workload placed on each ES so far in slot t


def init_queues(p: EnvParams, device=None) -> QueueState:
    z = torch.zeros((p.num_bs,), dtype=torch.float32, device=device)
    return QueueState(q_prev=z, q_bef=z)


def observe(p: EnvParams, qs: QueueState, d, workload, slack=None, f=None,
            avail=None) -> torch.Tensor:
    """Per-task state vector (Eqn 6), vectorised over the B stations.

    d, workload: (B,) — the n-th task of each BS.  Returns (B, state_dim):
    ``[d, workload, q_1..q_B]``, then ``[min(slack, slack_cap),
    workload / f_1..B]`` with QoS, then the availability vector LAST with
    faults."""
    B = p.num_bs
    cols = [d[:, None], workload[:, None], qs.q_prev[None, :].expand(B, B)]
    if p.has_qos:
        if slack is None or f is None:
            raise ValueError("QoS-enabled EnvParams: observe() needs the "
                             "per-task deadline slack and capacities f")
        cols.append(torch.clamp(slack, max=p.slack_cap)[:, None])
        cols.append(workload[:, None] / f[None, :])
    if p.has_faults:
        if avail is None:
            raise ValueError("fault-enabled EnvParams: observe() needs "
                             "the per-ES availability vector")
        cols.append(avail[None, :].expand(B, B))
    return torch.cat(cols, dim=1)


def task_delays(p: EnvParams, ep: EpisodeData, qs: QueueState, t: int,
                n: int, actions: torch.Tensor) -> torch.Tensor:
    """Service delay (Eqn 2) of the n-th task of every BS given actions
    (B,) in [0, B).  Returns (B,) delays in seconds."""
    f_tgt = ep.f[actions]
    workload = ep.rho[t, n] * ep.z[t, n]
    t_tx = ep.d[t, n] / ep.v_up[t, n] + ep.d_out[t, n] / ep.v_down[t, n]
    t_comp = workload / f_tgt
    t_wait = (qs.q_prev[actions] + qs.q_bef[actions]) / f_tgt   # Eqn (3)
    return t_tx + t_comp + t_wait


def apply_actions(p: EnvParams, ep: EpisodeData, qs: QueueState, t: int,
                  n: int, actions: torch.Tensor) -> QueueState:
    """Accumulate the placed workloads into the in-slot queue.  Several
    stations often pick one ES: ``index_add`` sums their workloads."""
    workload = ep.rho[t, n] * ep.z[t, n] * ep.mask[t, n]       # (B,)
    placed = torch.zeros((p.num_bs,), dtype=torch.float32,
                         device=workload.device).index_add_(0, actions,
                                                            workload)
    return QueueState(q_prev=qs.q_prev, q_bef=qs.q_bef + placed)


def end_slot(p: EnvParams, ep: EpisodeData, qs: QueueState,
             avail=None) -> QueueState:
    """Queue update at slot end (Eqn 4); with faults, DOWN servers
    (``avail == 0``) drain nothing this slot."""
    f = ep.f if avail is None else ep.f * avail
    q = torch.clamp(qs.q_prev + qs.q_bef - f * p.slot_seconds, min=0.0)
    return QueueState(q_prev=q, q_bef=torch.zeros_like(qs.q_bef))


def state_scale(p: EnvParams, device=None) -> torch.Tensor:
    """Feature normalisation for the networks (keeps inputs O(1))."""
    d_hi = p.d_range[1]
    w_hi = p.rho_range[1] * p.z_hi
    q_hi = p.rho_range[1] * p.z_hi * p.max_tasks  # rough slot load
    parts = [[d_hi, w_hi], [q_hi] * p.num_bs]
    if p.has_qos:
        parts += [[p.slack_cap], [w_hi / p.f_range[0]] * p.num_bs]
    if p.has_faults:
        parts.append([1.0] * p.num_bs)
    return torch.tensor([v for part in parts for v in part],
                        dtype=torch.float32, device=device)
