"""Drive any Scheduler against the simulator's episode loop.

Port of ``repro/cluster/simulate.py``.  This is the evaluation half of the
trainer's episode: no replay, no updates — the scheduler's ``select`` for
the B base stations at every (t, n), with queues coupling decisions via
Eqn (4).  The same scheduler object (same carry) can then be handed to
``repro_torch.cluster.live.EdgeCluster`` and place requests on engines.

With a QoS-enabled ``EnvParams`` the scheduler sees the extended
observation and ``evaluate_scheduler`` reports per-class percentiles,
deadline-miss rate and priority-weighted goodput; with faults it reports
``wrong_choice_rate`` and the terminal-status counts, as the reference
does.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.cluster.schedulers import Scheduler
from repro_torch.core import env as envlib


def build_sim_episode(scheduler: Scheduler, p: envlib.EnvParams
                      ) -> Callable:
    """episode(carry, ep_data, generator) -> (carry, delays (T,N,B),
    mask[, wrong]), all on the episode's device.

    With ``p.has_faults`` a fourth tensor holds the per-task wrong-choice
    flags (the scheduler picked a DOWN server and was remapped)."""

    def episode(carry, ep: envlib.EpisodeData, generator: torch.Generator):
        dev = ep.f.device
        scale = envlib.state_scale(p, dev)
        qs = envlib.init_queues(p, dev)
        av = envlib.init_avail(p.num_bs, dev)
        delays, wrongs = [], []
        for t in range(p.num_slots):
            for n in range(p.max_tasks):
                s = envlib.observe(p, qs, ep.d[t, n],
                                   ep.rho[t, n] * ep.z[t, n],
                                   slack=ep.deadline[t, n], f=ep.f,
                                   avail=av) / scale[None, :]
                actions, carry = scheduler.select(carry, s, n, generator)
                actions = actions % p.num_bs
                if p.has_faults:
                    actions, wrong = envlib.mask_actions(
                        av, qs.q_prev + qs.q_bef, actions)
                    penalty = p.fault.penalty_s * wrong
                    wrongs.append(wrong)
                else:
                    penalty = 0.0
                delays.append(envlib.task_delays(p, ep, qs, t, n, actions)
                              + penalty)
                qs = envlib.apply_actions(p, ep, qs, t, n, actions)
            if p.has_faults:
                qs = envlib.end_slot(p, ep, qs, avail=av)
                av = envlib.step_avail(p.fault, av, ep.avail_u[t])
            else:
                qs = envlib.end_slot(p, ep, qs)
        shape = (p.num_slots, p.max_tasks, p.num_bs)
        out = (carry, torch.stack(delays).reshape(shape), ep.mask)
        if p.has_faults:
            return out + (torch.stack(wrongs).reshape(shape),)
        return out

    return episode


def _percentiles(delays: np.ndarray) -> dict:
    if delays.size == 0:
        return {"mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0}
    return {"mean_s": float(delays.mean()),
            "p50_s": float(np.percentile(delays, 50)),
            "p95_s": float(np.percentile(delays, 95)),
            "p99_s": float(np.percentile(delays, 99))}


def evaluate_scheduler(scheduler: Scheduler, p: envlib.EnvParams,
                       episodes: int, seed: int = 0,
                       f: Optional[torch.Tensor] = None, carry=None,
                       device: DeviceLike = None) -> dict:
    """Delay percentiles (+ QoS and fault aggregates) over fresh episodes
    on ``device`` (``cuda`` unless the caller asks for the CPU).  Each
    episode's results come to the host once, after it ends."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    episode = build_sim_episode(scheduler, p)
    if f is None:
        f = envlib.sample_capacities(gen, p)
    if carry is None:
        carry = scheduler.init_carry()
    all_delays, all_cls, all_dl, all_prio, all_wrong = [], [], [], [], []
    for _ in range(episodes):
        ep_data = envlib.sample_episode(gen, p, f=f)
        res = episode(carry, ep_data, gen)
        carry = res[0]
        sel = res[2].cpu().numpy() > 0
        all_delays.append(res[1].cpu().numpy()[sel])
        all_cls.append(ep_data.cls.cpu().numpy()[sel])
        all_dl.append(ep_data.deadline.cpu().numpy()[sel])
        all_prio.append(ep_data.priority.cpu().numpy()[sel])
        if p.has_faults:
            all_wrong.append(res[3].cpu().numpy()[sel])
    delays = np.concatenate(all_delays) if all_delays else np.zeros((0,))
    out = {"count": int(delays.size), **_percentiles(delays)}
    # schema parity with the live summarize(): the slot-based sim has no
    # KV model, so cache efficiency is identically zero here
    out["prefill_tokens_saved"] = 0
    out["prefix_hit_rate"] = 0.0
    if p.has_faults:
        wrong = (np.concatenate(all_wrong) if all_wrong
                 else np.zeros((0,), bool))
        # sim tasks always complete (wrong picks are remapped + penalised)
        out.update(completed=int(delays.size), failed=0, abandoned=0,
                   retries=0, completion_rate=1.0,
                   wrong_choice_rate=(float(wrong.mean())
                                      if wrong.size else 0.0))
    if p.has_qos and delays.size:
        cls = np.concatenate(all_cls)
        dl = np.concatenate(all_dl)
        prio = np.concatenate(all_prio)
        missed = delays > dl
        has_dl = np.isfinite(dl)
        out["deadline_miss_rate"] = (float(missed[has_dl].mean())
                                     if has_dl.any() else 0.0)
        out["weighted_goodput"] = float((prio * ~missed).sum()
                                        / max(prio.sum(), 1e-9))
        classes = {}
        for i, (c, _) in enumerate(p.qos_mix):
            m = cls == i
            if not m.any():
                continue
            c_dl = m & has_dl
            classes[c.name] = {
                "count": int(m.sum()),
                "priority": float(c.priority),
                **_percentiles(delays[m]),
                "deadline_miss_rate": (float(missed[c_dl].mean())
                                       if c_dl.any() else 0.0),
                "weighted_goodput": float((prio[m] * ~missed[m]).sum()
                                          / max(prio[m].sum(), 1e-9)),
            }
        out["classes"] = classes
    out["carry"] = carry
    return out
