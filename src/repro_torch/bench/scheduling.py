"""Scheduling benches mirroring the paper's Figs. 5-8.

Port of ``benchmarks/scheduling.py`` over ``core/trainer.py``'s
``train_method`` / ``evaluate_method`` (each run's generator made from
its seed on ``device``: ``cuda`` unless the caller asks for the CPU).
Two scales:
  quick  — shrunk env (minutes): relative ordering only.
  paper  — Table III parameters (B=20, N<=50, |T|=60, 60+ episodes).

Rows are the reference's ``name,us_per_call,derived`` CSV.  Beyond the
reference, ``episodes`` / ``eval_episodes`` and the swept values cut a
run to fit a time budget, and a ``records`` list, when given, receives
one record per training run: its episodes, task steps, wall time and
``ladn_denoise`` launches (the LAD-TS and D2SAC-TS chains; three a
training task step, one an evaluation step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.agents import AgentConfig
from repro_torch.core.diffusion import DiffusionPolicyConfig
from repro_torch.core.env import EnvParams
from repro_torch.core.trainer import LEARNED, evaluate_method, train_method
from repro_torch.kernels import ops

HEURISTICS = ("opt-ts", "random-ts", "local-ts")


def env_for_scale(scale: str, **overrides) -> EnvParams:
    if scale == "paper":
        base = EnvParams()                      # Table III defaults
    else:
        base = EnvParams(num_bs=6, num_slots=15, max_tasks=8)
    return dataclasses.replace(base, **overrides)


def episodes_for_scale(scale: str) -> int:
    return 60 if scale == "paper" else 12


def agent_cfg(scale: str, **overrides) -> AgentConfig:
    return dataclasses.replace(
        AgentConfig(train_after=300 if scale == "paper" else 60,
                    replay_capacity=1000 if scale == "paper" else 300),
        **overrides)


def convergence_episode(delays: List[float], tol: float = 0.05) -> int:
    """First episode from which the delay stays within tol of the final
    plateau (the paper's 'converged after N episodes' metric).

    Robust to degenerate inputs: empty / single-episode curves return 0,
    and the plateau window never exceeds the curve length, so short runs
    (< 3 episodes) don't wrap the slice around."""
    arr = np.asarray(delays, dtype=np.float64)
    if arr.size == 0:
        return 0
    win = min(arr.size, max(3, arr.size // 5))
    plateau = arr[-win:].mean()
    band = tol * max(abs(plateau), 1e-12)
    for i, d in enumerate(arr):
        if abs(d - plateau) <= band and \
                (np.abs(arr[i:] - plateau) <= 3 * band).mean() > 0.7:
            return i
    return arr.size - 1


def _train(bench: str, method: str, p: EnvParams, cfg: AgentConfig,
           episodes: int, seed: int, dev, records: Optional[list]):
    """``train_method`` with its record appended to ``records``."""
    before = ops.launches["ladn_denoise"]
    t0 = time.time()
    delays, states = train_method(method, p, cfg, episodes=episodes,
                                  seed=seed, device=dev)
    wall = time.time() - t0
    if records is not None:
        records.append({"bench": bench, "method": method,
                        "episodes": episodes,
                        "task_steps": episodes * p.num_slots * p.max_tasks,
                        "wall_s": wall, "delays": delays,
                        "ladn_launches": ops.launches["ladn_denoise"]
                        - before})
    return delays, states, wall


def _evaluate(method, p, cfg, states, seed, n, dev, records):
    before = ops.launches["ladn_denoise"]
    delay = evaluate_method(method, p, cfg, states, seed=seed,
                            n_episodes=n, device=dev)
    if records is not None:
        records[-1].update(eval_episodes=n, eval_delay=delay,
                           eval_steps=n * p.num_slots * p.max_tasks,
                           eval_ladn_launches=ops.launches["ladn_denoise"]
                           - before)
    return delay


def bench_fig5_learning(scale: str, seed: int = 0,
                        device: DeviceLike = None,
                        episodes: Optional[int] = None,
                        records: Optional[list] = None):
    """Fig. 5: learning curves + convergence episodes + final delay.
    Returns (rows, curves)."""
    dev = resolve_device(device)
    p = env_for_scale(scale)
    cfg = agent_cfg(scale)
    eps = episodes or episodes_for_scale(scale)
    rows = []
    curves: Dict[str, List[float]] = {}
    for method in ("lad-ts", "d2sac-ts", "sac-ts", "dqn-ts", "opt-ts",
                   "random-ts"):
        n_eps = eps if method in LEARNED else 3
        delays, _, wall = _train("fig5_learning", method, p, cfg, n_eps,
                                 seed, dev, records)
        curves[method] = delays
        final = float(np.mean(delays[-3:]))
        conv = convergence_episode(delays) if n_eps > 5 else 0
        us = wall / max(n_eps, 1) * 1e6
        rows.append(f"fig5_learning/{method},{us:.0f},"
                    f"final_delay={final:.3f}s;converged_ep={conv}")
    return rows, curves


def bench_sweep(scale: str, param: str, values, seed: int = 1,
                methods=("lad-ts", "sac-ts", "opt-ts"),
                device: DeviceLike = None, episodes: Optional[int] = None,
                eval_episodes: int = 2,
                records: Optional[list] = None) -> List[str]:
    """Figs. 6-7: delay vs an environment parameter.

    param in {max_tasks, f_hi, z_hi, num_bs}.
    """
    dev = resolve_device(device)
    rows = []
    for v in values:
        over = {}
        if param == "max_tasks":
            over["max_tasks"] = int(v)
        elif param == "f_hi":
            over["f_range"] = (10.0, float(v))
        elif param == "z_hi":
            over["z_range"] = (1.0, float(v))
        elif param == "num_bs":
            over["num_bs"] = int(v)
        p = env_for_scale(scale, **over)
        cfg = agent_cfg(scale)
        eps = episodes or max(episodes_for_scale(scale) // 2, 6)
        for method in methods:
            t0 = time.time()
            n_eps = eps if method not in HEURISTICS else 1
            _, states, _ = _train(f"sweep_{param}", method, p, cfg, n_eps,
                                  seed, dev, records)
            final = _evaluate(method, p, cfg, states, seed + 1,
                              eval_episodes, dev, records)
            us = (time.time() - t0) / max(n_eps, 1) * 1e6
            rows.append(f"sweep_{param}={v}/{method},{us:.0f},"
                        f"delay={final:.3f}s")
    return rows


def bench_fig8_params(scale: str, seed: int = 2, device: DeviceLike = None,
                      episodes: Optional[int] = None,
                      eval_episodes: int = 2, steps=(1, 3, 5, 8),
                      alphas=(0.01, 0.05, 0.2),
                      records: Optional[list] = None) -> List[str]:
    """Fig. 8: denoising steps I and entropy temperature alpha."""
    dev = resolve_device(device)
    p = env_for_scale(scale)
    eps = episodes or max(episodes_for_scale(scale) // 2, 6)
    rows = []
    runs = ([(f"fig8a_denoise_I={i}", agent_cfg(
        scale, diffusion=DiffusionPolicyConfig(num_steps=i))) for i in steps]
        + [(f"fig8b_alpha={a}", agent_cfg(scale, init_alpha=a))
           for a in alphas])
    for label, cfg in runs:
        t0 = time.time()
        _, states, _ = _train(label, "lad-ts", p, cfg, eps, seed, dev,
                              records)
        final = _evaluate("lad-ts", p, cfg, states, seed + 1, eval_episodes,
                          dev, records)
        us = (time.time() - t0) / eps * 1e6
        rows.append(f"{label}/lad-ts,{us:.0f},delay={final:.3f}s")
    return rows
