"""Closed-loop edge cluster: a Scheduler placing requests on live engines.

Port of ``repro/cluster/live.py``.  The observation handed to the
scheduler is the Eqn-6 row ``[d_n, workload_n, q_1..q_E]``: prompt
tokens, requested generation length and per-engine backlog in pending
tokens, each divided by a fixed scale.  Three extensions, appended in
this order, as in the reference:

* QoS (``qos_obs``): the request's remaining deadline budget (capped at
  ``slack_cap``) and a per-engine affinity, the request's expected decode
  seconds there (``max_new_tokens x est_token_seconds``, times
  ``pref_penalty`` on engines whose arch is not the request's
  ``model_pref``);
* availability (``fault_obs``): each engine's health as 1 healthy, 0.5
  degraded, 0 down;
* prefix (``prefix_obs``, declared by a scheduler's ``prefix_obs``): a
  last per-engine block of expected prefix hits, each engine's
  ``expected_prefix_tokens`` over ``hit_scale``.

The layout is inferred from the scheduler's ``state_dim`` net of the
prefix block and checked at construction.

Fault tolerance (``repro_torch.faults``): a :class:`FaultInjector`
drives scheduled crash / stall / slowdown / recovery transitions on the
run-relative clock, and an exception escaping one engine's ``dispatch``,
``collect`` or serial ``step`` quarantines that engine (DOWN, KV
reclaimed, its requests re-offloaded) instead of unwinding the closed
loop.  One exception to the reference: a fault of the kernels or of the
card (raised inside ``repro_torch.kernels``: a build, a launch or a
wrapper refusing its inputs; or a CUDA error) propagates, because it
would fail every engine alike and a sticky CUDA error poisons every later
call.  Orphaned requests are re-offloaded through the scheduler with
capped retries and exponential backoff; the watchdog (on only when
``faults`` or ``retry`` is given) abandons requests whose deadline is
hopeless.  ``submit`` masks placement away from DOWN engines.

``step`` is overlapped by default: every engine's round is dispatched
before any engine's results are collected; ``overlap=False`` steps the
engines one after another, with the same tokens and statuses.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.cluster.request import Request
from repro_torch.cluster.schedulers import Scheduler
from repro_torch.faults import FaultEvent, FaultInjector, RetryPolicy


def kernel_fault(exc: BaseException) -> bool:
    """True for a fault no engine may absorb: an exception raised inside
    ``repro_torch.kernels`` (or caused by one) or a CUDA error."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, getattr(torch, "AcceleratorError", ())) or \
                "CUDA error" in str(exc):
            return True
        tb = exc.__traceback__
        while tb is not None:
            if tb.tb_frame.f_globals.get("__name__", "").startswith(
                    "repro_torch.kernels"):
                return True
            tb = tb.tb_next
        exc = exc.__cause__ or exc.__context__
    return False


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


class EdgeCluster:
    """N engines + one scheduler, driven as a closed loop."""

    def __init__(self, engines: Sequence, scheduler: Scheduler,
                 obs: Optional[LiveObsConfig] = None, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 qos_obs: Optional[bool] = None,
                 faults: Union[FaultInjector, Iterable[FaultEvent],
                               None] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_obs: Optional[bool] = None,
                 prefix_obs: Optional[bool] = None,
                 overlap: bool = True):
        self.overlap = bool(overlap)
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

        # fault machinery
        if faults is not None and not isinstance(faults, FaultInjector):
            faults = FaultInjector(list(faults), num_engines=E)
        self.injector: Optional[FaultInjector] = faults
        # the watchdog sheds only when the fault layer was asked for: a
        # fault-free cluster behaves exactly like one without it
        self._watchdog = faults is not None or retry is not None
        self.retry = retry or RetryPolicy()
        self._retry_q: List = []       # (ready_t, seq, Request) heap
        self._retry_seq = 0
        self._t0: Optional[float] = None   # run-relative fault clock epoch
        self.fault_stats = {"injected": 0, "quarantined": 0,
                            "orphaned": 0, "retries": 0, "failed": 0,
                            "abandoned": 0, "orphan_recovery_s": []}

        # observation width: base or QoS-extended, plus an optional
        # availability block, plus an optional per-engine expected-
        # prefix-hit block appended last
        base_dim, qos_dim = 2 + E, 3 + 2 * E
        sched_dim = getattr(scheduler, "state_dim", None)
        if prefix_obs is None:
            prefix_obs = bool(getattr(scheduler, "prefix_obs", False))
        self.prefix_obs = bool(prefix_obs)
        # infer the QoS/fault layout from the width net of the prefix block
        eff_dim = (sched_dim - E if (sched_dim is not None
                                     and self.prefix_obs) else sched_dim)
        if qos_obs is None:
            qos_obs = eff_dim in (qos_dim, qos_dim + E)
        self.qos_obs = bool(qos_obs)
        if fault_obs is None:
            fault_obs = (eff_dim in (base_dim + E, qos_dim + E)
                         if eff_dim is not None
                         else self.injector is not None)
        self.fault_obs = bool(fault_obs)
        self.obs_dim = ((qos_dim if self.qos_obs else base_dim)
                        + (E if self.fault_obs else 0)
                        + (E if self.prefix_obs else 0))
        if sched_dim is not None and sched_dim != self.obs_dim:
            raise ValueError(
                f"scheduler {scheduler.name!r} expects state_dim="
                f"{sched_dim}, but this {E}-engine cluster produces "
                f"{self.obs_dim}-feature observations "
                f"({'QoS-extended 3+2E' if self.qos_obs else 'base 2+E'}"
                f"{' + E availability' if self.fault_obs else ''}"
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
        if self.fault_obs:
            cols.append(np.asarray([e.availability for e in self.engines],
                                   np.float32))
        if self.prefix_obs:
            # a pure peek at each engine's prefix index; dense and
            # cache-off engines report 0
            hit = np.asarray(
                [getattr(e, "expected_prefix_tokens", lambda r: 0)(req)
                 for e in self.engines], np.float32)
            cols.append(hit / self.obs.hit_scale)
        # NaN guard: a crashed engine's inf backlog or NaN rate must never
        # reach the policy's input
        row = np.nan_to_num(np.concatenate(cols), nan=0.0,
                            posinf=np.finfo(np.float32).max / 2,
                            neginf=0.0)
        return torch.from_numpy(row)

    def submit(self, req: Request) -> int:
        """The scheduler picks an available engine; the request joins its
        queue.  Raises when every engine is DOWN: admitting into a dead
        engine would strand the request."""
        avail = np.asarray([e.available for e in self.engines], bool)
        if not avail.any():
            raise RuntimeError(
                f"cannot place request {req.rid}: all "
                f"{len(self.engines)} engines are DOWN "
                f"({[e.fail_reason for e in self.engines]})")
        if req.t_arrival is None:
            # first placement: delay and the watchdog count from here, so
            # retries keep counting from the original arrival
            req.t_arrival = self._clock()
        req.attempts += 1
        s = self.observe(req)
        with tracing.span("scheduler.select", rid=req.rid):
            eng, self.carry = self.scheduler.select_one_masked(
                self.carry, s, req.origin, self._count % self.n_max,
                self._gen, avail)
        self._count += 1
        self.engines[eng].admit(req)
        return eng

    # ------------------------------------------------------------------
    # fault handling
    # ------------------------------------------------------------------
    def _now_rel(self) -> float:
        """Run-relative seconds (the injector's and the trace's clock)."""
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def _apply_faults(self, now_rel: float) -> List[Request]:
        """Fire due injector events; returns terminal casualties."""
        if self.injector is None:
            return []
        terminal: List[Request] = []
        for ev in self.injector.due(now_rel):
            e = self.engines[ev.engine]
            self.fault_stats["injected"] += 1
            if ev.kind == "crash":
                if e.available:
                    terminal += self._crash(ev.engine, "injected crash")
            elif ev.kind == "recover":
                e.recover()
            elif ev.kind == "stall":
                if e.available:
                    e.degrade(stall_s=ev.duration_s,
                              reason="injected stall")
            elif ev.kind == "slowdown":
                if e.available:
                    e.degrade(slow_every=ev.factor,
                              reason="injected slowdown")
        return terminal

    def _crash(self, idx: int, reason: str) -> List[Request]:
        """Fail one engine, reclaim its KV, re-offload its requests."""
        now = self._clock()
        orphans = self.engines[idx].fail(reason)
        self.fault_stats["orphaned"] += len(orphans)
        terminal: List[Request] = []
        for r in orphans:
            r.t_orphaned = now
            terminal += self._requeue(r, now)
        return terminal

    def _requeue(self, r: Request, now: float) -> List[Request]:
        """Route one recovered request: retry with backoff, or give up."""
        r.reset_for_retry()
        if r.attempts >= self.retry.max_attempts:
            r.give_up("failed", f"retries exhausted "
                                f"({self.retry.max_attempts} attempts)")
            self.fault_stats["failed"] += 1
            return [r]
        if self.retry.hopeless(r, now):
            r.give_up("abandoned", "watchdog: deadline hopeless at retry")
            self.fault_stats["abandoned"] += 1
            return [r]
        ready = now + self.retry.backoff_s(r.attempts)
        heapq.heappush(self._retry_q, (ready, self._retry_seq, r))
        self._retry_seq += 1
        self.fault_stats["retries"] += 1
        return []

    def _park(self, r: Request, ready: float) -> None:
        """Hold an arrival that cannot be placed now (total outage) until
        an engine comes back; it does not consume a retry attempt."""
        heapq.heappush(self._retry_q, (ready, self._retry_seq, r))
        self._retry_seq += 1

    def _flush_retries(self, now: float) -> List[Request]:
        """Re-offload due retries; abandon the ones the watchdog flags.

        Hopeless entries are abandoned even during a total outage, so a
        never-recovering cluster still drains to a terminal state."""
        terminal: List[Request] = []
        while self._retry_q and self._retry_q[0][0] <= now:
            r = self._retry_q[0][-1]
            if self.retry.hopeless(r, now):
                heapq.heappop(self._retry_q)
                r.give_up("abandoned", "watchdog: deadline hopeless")
                self.fault_stats["abandoned"] += 1
                terminal.append(r)
                continue
            if not any(e.available for e in self.engines):
                break                   # total outage: wait for recovery
            heapq.heappop(self._retry_q)
            if r.t_orphaned is not None:
                self.fault_stats["orphan_recovery_s"].append(
                    now - r.t_orphaned)
                r.t_orphaned = None
            self.submit(r)
        return terminal

    def _shed_hopeless(self, now: float) -> List[Request]:
        """Watchdog sweep over every engine's queued (not yet running)
        requests: overload degrades by shedding, not by collapsing."""
        if not self._watchdog:
            return []
        terminal: List[Request] = []
        for e in self.engines:
            for r in e.shed(lambda r: self.retry.hopeless(r, now)):
                r.give_up("abandoned", "watchdog: deadline hopeless in "
                                       "queue")
                self.fault_stats["abandoned"] += 1
                terminal.append(r)
        return terminal

    def _quarantine(self, i: int, exc: Exception) -> List[Request]:
        """Mark engine ``i`` DOWN after it raised ``exc`` and re-offload
        its requests; a kernel or card fault is raised again instead."""
        if kernel_fault(exc):
            raise exc
        self.fault_stats["quarantined"] += 1
        return self._crash(i, f"quarantined: {exc!r}")

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One cluster iteration; returns the requests that reached a
        terminal state this step (completed, failed or abandoned).

        Overlapped (default): every engine's round is dispatched before
        any engine's results are collected; ``overlap=False`` runs each
        engine's ``step`` in turn.  An exception from one engine
        quarantines it (DOWN, KV reclaimed, requests re-offloaded) unless
        it is a kernel or card fault (``kernel_fault``), which
        propagates."""
        with tracing.span("cluster.step"):
            return self._step()

    def _step(self) -> List[Request]:
        now_rel = self._now_rel()
        now = self._clock()
        done: List[Request] = []
        done += self._apply_faults(now_rel)
        done += self._flush_retries(now)
        done += self._shed_hopeless(now)
        if not self.overlap:
            for i, e in enumerate(self.engines):
                if not e.available:
                    continue
                try:
                    done += e.step()
                except Exception as exc:  # noqa: BLE001 — quarantine all
                    done += self._quarantine(i, exc)
            return done
        for i, e in enumerate(self.engines):
            if not e.available:
                continue
            try:
                e.dispatch()
            except Exception as exc:   # noqa: BLE001 — quarantine all
                done += self._quarantine(i, exc)
        for i, e in enumerate(self.engines):
            if not e.available:         # crashed during dispatch: its
                continue                # pending round was dropped
            try:
                done += e.collect()
            except Exception as exc:   # noqa: BLE001 — quarantine all
                done += self._quarantine(i, exc)
        return done

    @property
    def busy(self) -> bool:
        return (any(e.has_work for e in self.engines)
                or bool(self._retry_q))

    # ------------------------------------------------------------------
    def run(self, trace: Sequence[Request], max_steps: int = 1_000_000
            ) -> List[Request]:
        """Replay an arrival trace in real time; returns terminal requests.

        Requests become visible to the scheduler when the clock reaches
        their ``arrival_s``; ``service_s`` then measures the full
        arrival-to-finish delay.  Injector events share the same
        run-relative clock.  Arrivals during a total outage are parked
        and placed on recovery; once the trace is served, the loop keeps
        polling the injector until its schedule is exhausted."""
        todo = sorted(trace, key=lambda r: r.arrival_s)
        done: List[Request] = []
        i = 0
        # warm the scheduler's select path (a learned policy builds and
        # runs its kernel) outside the timed loop; the carry it returns is
        # dropped, so the warm-up leaves no latent or counter behind
        self.scheduler.select_one(
            self.carry, torch.zeros((self.obs_dim,), dtype=torch.float32),
            0, 0, torch.Generator().manual_seed(0))
        self._t0 = t0 = self._clock()
        for _ in range(max_steps):
            if i >= len(todo) and not self.busy:
                if self.injector is None or self.injector.exhausted:
                    break
                # quiescent but faults still scheduled: fast-forward
                self._apply_faults(self._now_rel())
                time.sleep(0.001)
                continue
            now = self._clock() - t0
            while i < len(todo) and todo[i].arrival_s <= now:
                todo[i].t_arrival = t0 + todo[i].arrival_s
                if any(e.available for e in self.engines):
                    self.submit(todo[i])
                else:                  # total outage: park until recovery
                    self._park(todo[i], self._clock())
                i += 1
            if self.busy:
                done += self.step()
                if not any(e.available and e.has_work
                           for e in self.engines):
                    time.sleep(0.001)  # only waiting on recovery/backoff
            elif i < len(todo):
                time.sleep(min(0.002, max(todo[i].arrival_s - now, 0.0)))
        return done
