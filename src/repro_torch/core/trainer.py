"""Online distributed training harness (Algorithm 1).

Port of ``repro/core/trainer.py``.  An episode is a host loop over the T
time slots and the N_max task slots of each; at every (t, n) the B per-ES
agents decide together (one call over the stacked agent state, so for
LAD-TS one fused-chain kernel launch for all B decisions), and the queues
couple them through Eqn (4).  The reference scans the same loop under
``jit``.

Transitions are completed one step late (s_next is observed at the next
(t, n)), stored in each agent's pool and, once that pool holds more than
``train_after`` items, every step applies one update per agent
(Algorithm 1 lines 15-18).  The update is computed for all agents and kept
per agent with ``torch.where``, as the reference does, so the loop never
waits for the device: everything stays on the device until the episode's
average delay is read at its end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import agents as ag
from repro_torch.core import env as envlib
from repro_torch.core.optim import tree_map
from repro_torch.core.replay import sample_indices

METHODS = ("lad-ts", "d2sac-ts", "sac-ts", "dqn-ts", "opt-ts", "random-ts",
           "local-ts")
LEARNED = ("lad-ts", "d2sac-ts", "sac-ts", "dqn-ts")


class AgentFns(NamedTuple):
    """One learned method's functions over a stacked agent state.

    ``act(state, s, n, generator, noise=None) -> (actions,
    x_used, state)`` for s (G, S) and task slot n; ``update(state,
    generator, noise=None) -> (state, metrics)``.  ``noise`` (a dict of
    the draws, as ``draw_act(state, generator)`` makes them for ``act``)
    replaces the generator's draws."""

    init: Callable
    act: Callable
    update: Callable
    latent: Callable
    draw_act: Callable


def make_agent_fns(method: str, cfg: ag.AgentConfig) -> AgentFns:
    """The functions of a learned method, all over stacked agent states."""
    K = cfg.batch_size

    def draw_idx(state, generator):
        return {"idx": sample_indices(state.replay, K, generator)}

    if method in ("lad-ts", "d2sac-ts"):
        dcfg = dataclasses.replace(cfg.diffusion,
                                   latent_init=(method == "lad-ts"))
        cfg = dataclasses.replace(cfg, diffusion=dcfg)
        I = dcfg.num_steps  # noqa: E741

        def init(generator, sd, adim, nmax, num_agents):
            return ag.ladts_init(generator, cfg, sd, adim, nmax, num_agents)

        def draw_act(state, generator):
            G, _, A = state.X.shape
            noise = {"chain": ag.draw_chain_noise(G, 1, A, I, generator),
                     "gumbel": ag.gumbel((G, A), generator)}
            if not dcfg.latent_init:
                noise["x_used"] = torch.randn((G, A), generator=generator,
                                              device=generator.device)
            return noise

        def act(state, s, n, generator=None, noise=None):
            noise = noise if noise is not None else draw_act(state,
                                                             generator)
            x_used = state.X[:, n] if dcfg.latent_init else noise["x_used"]
            a, state = ag.ladts_act(state, cfg, s, n, noise["chain"],
                                    noise["gumbel"])
            return a, x_used, state

        def draw_update(state, generator):
            G, _, A = state.X.shape
            noise = draw_idx(state, generator)
            for k in ("next", "actor", "now"):
                noise[k] = ag.draw_chain_noise(G, K, A, I, generator)
            return noise

        def update(state, generator=None, noise=None):
            noise = noise if noise is not None else draw_update(state,
                                                                generator)
            return ag.ladts_update(state, cfg, noise["idx"], noise["next"],
                                   noise["actor"], noise["now"])

        def latent(state, n):
            return state.X[:, n]

    elif method in ("sac-ts", "dqn-ts"):
        sac = method == "sac-ts"

        def init(generator, sd, adim, nmax, num_agents):
            fn = ag.sac_init if sac else ag.dqn_init
            return fn(generator, cfg, sd, adim, nmax, num_agents)

        def latent(state, n):
            b = (state.c1 if sac else state.q)[-1]["b"]
            return torch.zeros_like(b)

        def draw_act(state, generator):
            G, A = latent(state, 0).shape
            if sac:
                return {"gumbel": ag.gumbel((G, A), generator)}
            dev = generator.device
            return {"rand_a": torch.randint(0, A, (G,), generator=generator,
                                            device=dev),
                    "u": torch.rand((G,), generator=generator, device=dev)}

        def act(state, s, n, generator=None, noise=None):
            noise = noise if noise is not None else draw_act(state,
                                                             generator)
            if sac:
                a = ag.sac_act(state, cfg, s, noise["gumbel"])
            else:
                a = ag.dqn_act(state, cfg, s, noise["rand_a"], noise["u"])
            return a, latent(state, n), state

        def update(state, generator=None, noise=None):
            noise = noise if noise is not None else draw_idx(state,
                                                             generator)
            fn = ag.sac_update if sac else ag.dqn_update
            return fn(state, cfg, noise["idx"])

    else:
        raise ValueError(method)

    return AgentFns(init, act, update, latent, draw_act)


class Pending(NamedTuple):
    """Previous step's half-built transitions (B, ...)."""
    s: torch.Tensor
    x: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    valid: torch.Tensor


def heuristic_actions(method: str, p: envlib.EnvParams, ep, qs, t: int,
                      n: int, generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Non-learned schedulers' (B,) actions."""
    B, dev = p.num_bs, ep.f.device
    if method == "random-ts":
        return torch.randint(0, B, (B,), generator=generator, device=dev)
    if method == "local-ts":
        return torch.arange(B, device=dev)
    # opt-ts: the (B_src, B_tgt) delay matrix from the true capacities and
    # queues; each task takes its fastest target
    d = ep.d[t, n][:, None]
    wl = (ep.rho[t, n] * ep.z[t, n])[:, None]
    f = ep.f[None, :]
    delay = (d / ep.v_up[t, n][:, None] + ep.d_out[t, n][:, None]
             / ep.v_down[t, n][:, None] + wl / f
             + (qs.q_prev + qs.q_bef)[None, :] / f)
    return torch.argmin(delay, dim=1)


def _select(do_train: torch.Tensor, old, new):
    """Per agent: ``new`` where ``do_train`` (G,) is set, else ``old``."""
    return tree_map(lambda a, b: torch.where(
        do_train.reshape((-1,) + (1,) * (a.dim() - 1)), b, a), old, new)


def build_episode_fn(method: str, p: envlib.EnvParams, cfg: ag.AgentConfig,
                     train: bool = True) -> Callable:
    """episode(states, ep_data, generator) -> (states, avg_delay): the
    average delay stays a 0-dim device tensor (the caller reads it)."""
    learned = method in LEARNED
    if learned:
        fns = make_agent_fns(method, cfg)
    B = p.num_bs

    def episode(states, ep: envlib.EpisodeData, generator: torch.Generator):
        dev = ep.f.device
        scale = envlib.state_scale(p, dev)
        qs = envlib.init_queues(p, dev)
        av = envlib.init_avail(B, dev)
        pend = Pending(s=torch.zeros((B, p.state_dim), device=dev),
                       x=torch.zeros((B, p.action_dim), device=dev),
                       a=torch.zeros((B,), dtype=torch.int64, device=dev),
                       r=torch.zeros((B,), device=dev),
                       valid=torch.zeros((B,), dtype=torch.bool,
                                         device=dev))
        tot_delay = torch.zeros((), device=dev)
        tot_tasks = torch.zeros((), device=dev)
        for t in range(p.num_slots):
            for n in range(p.max_tasks):
                s = envlib.observe(p, qs, ep.d[t, n],
                                   ep.rho[t, n] * ep.z[t, n],
                                   slack=ep.deadline[t, n], f=ep.f,
                                   avail=av) / scale[None, :]
                if learned:
                    # complete the pending transition with s_next = s
                    x_next = (fns.latent(states, n) if method == "lad-ts"
                              else torch.zeros_like(pend.x))
                    trans = ag.Transition(s=pend.s, x=pend.x, a=pend.a,
                                          r=pend.r, s_next=s, x_next=x_next)
                    states = ag.add_replay(states, trans, pend.valid)
                    # evaluation samples from pi too: greedy decisions make
                    # the B schedulers herd onto the same fast ES
                    actions, x_used, states = fns.act(states, s, n,
                                                      generator)
                else:
                    actions = heuristic_actions(method, p, ep, qs, t, n,
                                                generator)
                    x_used = pend.x
                actions = actions % B
                if p.has_faults:
                    # the agent owns its choice (replay keeps it); the
                    # cluster executes the availability-masked remap
                    executed, wrong = envlib.mask_actions(
                        av, qs.q_prev + qs.q_bef, actions)
                    penalty = p.fault.penalty_s * wrong
                else:
                    executed, penalty = actions, 0.0
                delays = (envlib.task_delays(p, ep, qs, t, n, executed)
                          + penalty)
                # Eqn (9), priority-weighted, optional deadline penalty
                r = -delays * cfg.reward_scale * ep.priority[t, n]
                if p.deadline_penalty:
                    r = r - (cfg.reward_scale * p.deadline_penalty
                             * ep.priority[t, n]
                             * (delays > ep.deadline[t, n]))
                qs = envlib.apply_actions(p, ep, qs, t, n, executed)
                if learned and train:
                    do_train = states.replay.size > cfg.train_after
                    new, _ = fns.update(states, generator)
                    states = _select(do_train, states, new)
                pend = Pending(s=s, x=x_used, a=actions, r=r,
                               valid=ep.mask[t, n] > 0)
                tot_delay = tot_delay + (delays * ep.mask[t, n]).sum()
                tot_tasks = tot_tasks + ep.mask[t, n].sum()
            if p.has_faults:
                qs = envlib.end_slot(p, ep, qs, avail=av)
                av = envlib.step_avail(p.fault, av, ep.avail_u[t])
            else:
                qs = envlib.end_slot(p, ep, qs)
        return states, tot_delay / torch.clamp(tot_tasks, min=1.0)

    return episode


def init_agents(method: str, p: envlib.EnvParams, cfg: ag.AgentConfig,
                generator: torch.Generator):
    """B stacked agents on the generator's device (None for heuristics)."""
    if method not in LEARNED:
        return None
    return make_agent_fns(method, cfg).init(generator, p.state_dim,
                                            p.action_dim, p.max_tasks,
                                            p.num_bs)


def train_method(method: str, p: envlib.EnvParams, cfg: ag.AgentConfig,
                 episodes: int, seed: int = 0, verbose: bool = False,
                 f: Optional[torch.Tensor] = None,
                 device: DeviceLike = None):
    """Full training run on ``device`` (``cuda`` unless the caller asks
    for the CPU).  Returns (per-episode avg delays, final states).

    ES capacities ``f`` are sampled once (hardware is fixed across
    episodes); pass the same ``f`` to :func:`evaluate_method`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if f is None:
        f = envlib.sample_capacities(gen, p)
    states = init_agents(method, p, cfg, gen)
    episode = build_episode_fn(method, p, cfg, train=True)
    delays = []
    for e in range(episodes):
        ep_data = envlib.sample_episode(gen, p, f=f)
        t0 = time.perf_counter()
        states, avg = episode(states, ep_data, gen)
        avg = float(avg)                       # the episode's one sync
        delays.append(avg)
        if verbose:
            print(f"[{method}] episode {e:3d} avg_delay={avg:7.3f}s "
                  f"({time.perf_counter()-t0:.1f}s wall)", flush=True)
    return delays, states


def evaluate_method(method: str, p: envlib.EnvParams, cfg: ag.AgentConfig,
                    states, seed: int = 0, n_episodes: int = 5,
                    f: Optional[torch.Tensor] = None,
                    device: DeviceLike = None) -> float:
    """Average delay over fresh episodes without training updates."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    episode = build_episode_fn(method, p, cfg, train=False)
    if f is None:
        f = envlib.sample_capacities(gen, p)
    tot = 0.0
    for _ in range(n_episodes):
        ep_data = envlib.sample_episode(gen, p, f=f)
        _, avg = episode(states, ep_data, gen)
        tot += float(avg)
    return tot / n_episodes
