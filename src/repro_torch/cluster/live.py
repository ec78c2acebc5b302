"""Closed-loop edge cluster: a Scheduler placing requests on live engines.

Port of the fault-free core of ``repro/cluster/live.py``.  The
observation handed to the scheduler is the base Eqn-6 row
``[d_n, workload_n, q_1..q_E]``: prompt tokens, requested generation
length and per-engine backlog in pending tokens, each divided by a fixed
scale.  ``step`` is overlapped: every engine's round is dispatched before
any engine's results are collected, so the engines' device work queues up
together instead of paying one host round-trip each in turn.

Not here yet (ROADMAP.md A4): the QoS-extended and prefix observations,
fault injection, retry and the watchdog, and the quarantine that turns an
engine's exception into a DOWN engine.  In this slice an engine's
exception propagates to the caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.request import Request
from repro_torch.cluster.schedulers import Scheduler


@dataclasses.dataclass(frozen=True)
class LiveObsConfig:
    """Feature scales mapping live measurements into the sim's O(1) range."""

    d_scale: float = 32.0      # prompt tokens
    w_scale: float = 16.0      # decode-token demand
    q_scale: float = 64.0      # backlog tokens


class EdgeCluster:
    """N engines + one scheduler, driven as a closed loop."""

    def __init__(self, engines: Sequence, scheduler: Scheduler,
                 obs: Optional[LiveObsConfig] = None, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 qos_obs: Optional[bool] = None, faults=None, retry=None,
                 fault_obs: Optional[bool] = None,
                 prefix_obs: Optional[bool] = None):
        if (qos_obs or faults is not None or retry is not None or fault_obs
                or prefix_obs or getattr(scheduler, "prefix_obs", False)):
            raise NotImplementedError(
                "QoS, fault and prefix observations are not ported to "
                "repro_torch yet (ROADMAP.md A4)")
        if scheduler.num_engines != len(engines):
            raise ValueError(
                f"scheduler targets {scheduler.num_engines} engines, "
                f"cluster has {len(engines)}")
        self.engines = list(engines)
        for i, e in enumerate(self.engines):
            e.engine_id = i
        self.scheduler = scheduler
        self.obs = obs or LiveObsConfig()
        self.obs_dim = 2 + len(self.engines)
        sched_dim = getattr(scheduler, "state_dim", None)
        if sched_dim is not None and sched_dim != self.obs_dim:
            raise ValueError(
                f"scheduler {scheduler.name!r} expects state_dim="
                f"{sched_dim}, but this {len(self.engines)}-engine cluster "
                f"produces base 2+E = {self.obs_dim}-feature observations")
        self.carry = scheduler.init_carry()
        self._gen = torch.Generator().manual_seed(seed)
        self._count = 0
        self._clock = clock
        # task slots wrap at the scheduler's N_max (a learned policy's
        # latent store holds N_max rows)
        self.n_max = int(getattr(scheduler, "n_max", 1))

    # ------------------------------------------------------------------
    def observe(self, req: Request) -> torch.Tensor:
        """Eqn-6 style observation row for one arriving request."""
        q = np.asarray([e.pending_tokens for e in self.engines], np.float32)
        prompt_len = req.prompt.shape[-1]
        row = np.concatenate([
            np.asarray([prompt_len / self.obs.d_scale,
                        req.max_new_tokens / self.obs.w_scale], np.float32),
            q / self.obs.q_scale])
        row = np.nan_to_num(row, nan=0.0,
                            posinf=np.finfo(np.float32).max / 2, neginf=0.0)
        return torch.from_numpy(row)

    def submit(self, req: Request) -> int:
        """The scheduler picks an available engine; the request joins its
        queue.  Raises when every engine is DOWN."""
        avail = np.asarray([e.available for e in self.engines], bool)
        if not avail.any():
            raise RuntimeError(
                f"cannot place request {req.rid}: all "
                f"{len(self.engines)} engines are DOWN")
        if req.t_arrival is None:
            req.t_arrival = self._clock()
        req.attempts += 1
        s = self.observe(req)
        eng, self.carry = self.scheduler.select_one_masked(
            self.carry, s, req.origin, self._count % self.n_max, self._gen,
            avail)
        self._count += 1
        self.engines[eng].admit(req)
        return eng

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One overlapped cluster iteration: dispatch every engine, then
        collect every engine; returns the requests finished this step."""
        for e in self.engines:
            if e.available:
                e.dispatch()
        done: List[Request] = []
        for e in self.engines:
            if e.available:
                done += e.collect()
        return done

    @property
    def busy(self) -> bool:
        return any(e.has_work for e in self.engines)

    # ------------------------------------------------------------------
    def run(self, trace: Sequence[Request], max_steps: int = 1_000_000
            ) -> List[Request]:
        """Replay an arrival trace in real time; returns finished requests.

        Requests become visible to the scheduler when the wall clock
        reaches their ``arrival_s``; ``service_s`` then measures the full
        arrival-to-finish delay."""
        todo = sorted(trace, key=lambda r: r.arrival_s)
        done: List[Request] = []
        i = 0
        # warm the scheduler's select path (a learned policy builds and
        # runs its kernel) outside the timed loop; the carry it returns is
        # dropped, so the warm-up leaves no latent or counter behind
        self.scheduler.select_one(
            self.carry, torch.zeros((self.obs_dim,), dtype=torch.float32),
            0, 0, torch.Generator().manual_seed(0))
        t0 = self._clock()
        for _ in range(max_steps):
            if i >= len(todo) and not self.busy:
                break
            now = self._clock() - t0
            while i < len(todo) and todo[i].arrival_s <= now:
                todo[i].t_arrival = t0 + todo[i].arrival_s
                self.submit(todo[i])
                i += 1
            if self.busy:
                done += self.step()
            elif i < len(todo):
                time.sleep(min(0.002, max(todo[i].arrival_s - now, 0.0)))
        return done
