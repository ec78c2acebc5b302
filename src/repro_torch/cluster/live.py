"""Closed-loop edge cluster: a Scheduler placing requests on live engines.

Port of the fault-free part of ``repro/cluster/live.py``.  The
observation handed to the scheduler is the Eqn-6 row
``[d_n, workload_n, q_1..q_E]``: prompt tokens, requested generation
length and per-engine backlog in pending tokens, each divided by a fixed
scale.  Two extensions, as in the reference:

* QoS (``qos_obs``): the request's remaining deadline budget (capped at
  ``slack_cap``) and a per-engine affinity, the request's expected decode
  seconds there (``max_new_tokens x est_token_seconds``, times
  ``pref_penalty`` on engines whose arch is not the request's
  ``model_pref``);
* prefix (``prefix_obs``, declared by a scheduler's ``prefix_obs``): a
  last per-engine block of expected prefix hits, each engine's
  ``expected_prefix_tokens`` over ``hit_scale``.

The QoS layout is inferred from the scheduler's ``state_dim`` net of the
prefix block and checked at construction.  ``step`` is overlapped: every
engine's round is dispatched before any engine's results are collected.

Not here yet (ROADMAP.md A4): fault injection, retry and the watchdog,
the availability observation, and the quarantine that turns an engine's
exception into a DOWN engine.  Here an engine's exception propagates to
the caller.
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
    # QoS-extended features
    slack_scale: float = 4.0   # seconds of remaining deadline budget
    slack_cap: float = 16.0    # best-effort requests report this slack
    c_scale: float = 1.0       # expected decode seconds on an engine
    pref_penalty: float = 4.0  # affinity inflation off the preferred arch
    # prefix-extended feature
    hit_scale: float = 32.0    # expected reusable prompt tokens per engine


def _no_faults() -> NotImplementedError:
    return NotImplementedError(
        "fault injection, retry and the availability observation are not "
        "ported to repro_torch yet (ROADMAP.md A4)")


class EdgeCluster:
    """N engines + one scheduler, driven as a closed loop."""

    def __init__(self, engines: Sequence, scheduler: Scheduler,
                 obs: Optional[LiveObsConfig] = None, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 qos_obs: Optional[bool] = None, faults=None, retry=None,
                 fault_obs: Optional[bool] = None,
                 prefix_obs: Optional[bool] = None):
        if faults is not None or retry is not None or fault_obs:
            raise _no_faults()
        if scheduler.num_engines != len(engines):
            raise ValueError(
                f"scheduler targets {scheduler.num_engines} engines, "
                f"cluster has {len(engines)}")
        self.engines = list(engines)
        for i, e in enumerate(self.engines):
            e.engine_id = i
        self.scheduler = scheduler
        self.obs = obs or LiveObsConfig()
        E = len(self.engines)
        # observation width: base or QoS-extended, plus an optional
        # per-engine expected-prefix-hit block appended last
        base_dim, qos_dim = 2 + E, 3 + 2 * E
        sched_dim = getattr(scheduler, "state_dim", None)
        if prefix_obs is None:
            prefix_obs = bool(getattr(scheduler, "prefix_obs", False))
        self.prefix_obs = bool(prefix_obs)
        # infer the QoS layout from the width net of the prefix block
        eff_dim = (sched_dim - E if (sched_dim is not None
                                     and self.prefix_obs) else sched_dim)
        if qos_obs is None:
            qos_obs = eff_dim in (qos_dim, qos_dim + E)
        self.qos_obs = bool(qos_obs)
        if fault_obs is None and eff_dim in (base_dim + E, qos_dim + E):
            raise _no_faults()    # a width only the availability block fits
        self.obs_dim = ((qos_dim if self.qos_obs else base_dim)
                        + (E if self.prefix_obs else 0))
        if sched_dim is not None and sched_dim != self.obs_dim:
            raise ValueError(
                f"scheduler {scheduler.name!r} expects state_dim="
                f"{sched_dim}, but this {E}-engine cluster produces "
                f"{self.obs_dim}-feature observations "
                f"({'QoS-extended 3+2E' if self.qos_obs else 'base 2+E'}"
                f"{' + E prefix-hit' if self.prefix_obs else ''}; "
                f"base={base_dim}, extended={qos_dim}, +faults adds "
                f"{E}, +prefix adds {E}).  Train the policy on an "
                f"EnvParams with num_bs={E} and matching qos_mix / fault "
                f"settings, or pass qos_obs= / fault_obs= / prefix_obs= "
                f"explicitly.")
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
        cols = [np.asarray([prompt_len / self.obs.d_scale,
                            req.max_new_tokens / self.obs.w_scale],
                           np.float32),
                q / self.obs.q_scale]
        if self.qos_obs:
            budget = req.deadline_budget_s
            if budget is None:
                slack = self.obs.slack_cap
            else:
                elapsed = (0.0 if req.t_arrival is None
                           else self._clock() - req.t_arrival)
                slack = min(budget - elapsed, self.obs.slack_cap)
            aff = np.asarray([req.max_new_tokens * e.est_token_seconds
                              for e in self.engines], np.float32)
            if req.model_pref is not None:
                mismatch = np.asarray(
                    [getattr(e, "arch_id", None) != req.model_pref
                     for e in self.engines])
                aff = np.where(mismatch, aff * self.obs.pref_penalty, aff)
            cols.append(np.asarray([slack / self.obs.slack_scale],
                                   np.float32))
            cols.append(aff / self.obs.c_scale)
        if self.prefix_obs:
            # a pure peek at each engine's prefix index; dense and
            # cache-off engines report 0
            hit = np.asarray(
                [getattr(e, "expected_prefix_tokens", lambda r: 0)(req)
                 for e in self.engines], np.float32)
            cols.append(hit / self.obs.hit_scale)
        # NaN guard: an engine's inf backlog or NaN rate must never reach
        # the policy's input
        row = np.nan_to_num(np.concatenate(cols), nan=0.0,
                            posinf=np.finfo(np.float32).max / 2,
                            neginf=0.0)
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
