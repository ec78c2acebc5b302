"""Latent-action diffusion machinery (paper §IV-A, Theorem 2).

Port of ``repro/core/diffusion.py``.  Forward-process variance schedule
(VP-SDE discretisation):

    beta_i = 1 - exp(-beta_min/I - (2i-1)/(2I^2) (beta_max - beta_min))

Reverse update (Eqn 10), i = I..1:

    x_{i-1} = (x_i - beta_i/sqrt(1-lambda_bar_i) * eps_theta(x_i,i,s))
              / sqrt(lambda_i)  +  (beta_tilde_i/2) * eps

with the paper's ``(beta_tilde_i / 2) * eps`` noise term by default and
DDPM's ``sqrt(beta_tilde_i) * eps`` with ``paper_variance=False``; no noise
on the final (i = 1) step.

Randomness is explicit: the chain's noise is passed in as a tensor of shape
``(I,) + x_I.shape`` (``noise[step]`` is used at ``i = I - step``), or drawn
from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor          # (I,) beta_1..beta_I  (index 0 = i=1)
    lambdas: torch.Tensor        # 1 - beta
    lambda_bars: torch.Tensor    # cumprod lambda
    beta_tildes: torch.Tensor    # posterior variances

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def make_schedule(num_steps: int, beta_min: float = 0.1,
                  beta_max: float = 10.0, device=None) -> DiffusionSchedule:
    """f32 schedule on ``device`` (the CPU by default)."""
    i = torch.arange(1, num_steps + 1, dtype=torch.float32, device=device)
    I = float(num_steps)  # noqa: E741
    betas = 1.0 - torch.exp(-beta_min / I
                            - (2 * i - 1) / (2 * I * I)
                            * (beta_max - beta_min))
    lambdas = 1.0 - betas
    lambda_bars = torch.cumprod(lambdas, 0)
    prev_bars = torch.cat([torch.ones((1,), device=device),
                           lambda_bars[:-1]])
    beta_tildes = (1.0 - prev_bars) / (1.0 - lambda_bars) * betas
    return DiffusionSchedule(betas, lambdas, lambda_bars, beta_tildes)


def make_schedule_np(num_steps: int, beta_min: float = 0.1,
                     beta_max: float = 10.0) -> DiffusionSchedule:
    """Numpy twin of :func:`make_schedule` (f32 arrays): the host-side
    constants the fused kernel takes as launch arguments."""
    i = np.arange(1, num_steps + 1, dtype=np.float32)
    I = float(num_steps)  # noqa: E741
    betas = 1.0 - np.exp(-beta_min / I
                         - (2 * i - 1) / (2 * I * I) * (beta_max - beta_min))
    lambdas = 1.0 - betas
    lambda_bars = np.cumprod(lambdas)
    prev_bars = np.concatenate([np.ones((1,), np.float32),
                                lambda_bars[:-1]])
    beta_tildes = (1.0 - prev_bars) / (1.0 - lambda_bars) * betas
    return DiffusionSchedule(betas, lambdas, lambda_bars, beta_tildes)


def forward_sample(sched: DiffusionSchedule, x0, i: int, eps):
    """Eqn (11): x_i = sqrt(lambda_bar_i) x_0 + sqrt(1-lambda_bar_i) eps.

    ``i`` is 1-based (array index i-1)."""
    lb = sched.lambda_bars[i - 1]
    return torch.sqrt(lb) * x0 + torch.sqrt(1.0 - lb) * eps


def reverse_step(sched: DiffusionSchedule, eps_pred, x_i, i: int, noise,
                 paper_variance: bool = True):
    """One Eqn-(10) update from x_i to x_{i-1}; ``i`` is 1-based."""
    idx = i - 1
    beta = sched.betas[idx]
    lam = sched.lambdas[idx]
    lbar = sched.lambda_bars[idx]
    btilde = sched.beta_tildes[idx]
    mean = (x_i - beta / torch.sqrt(1.0 - lbar) * eps_pred) / torch.sqrt(lam)
    scale = btilde / 2.0 if paper_variance else torch.sqrt(btilde)
    # no noise on the final (i=1) step, as in DDPM sampling
    if i == 1:
        scale = torch.zeros_like(scale)
    return mean + scale * noise


@dataclasses.dataclass(frozen=True)
class DiffusionPolicyConfig:
    num_steps: int = 5            # I (paper Table IV)
    beta_min: float = 0.1
    beta_max: float = 10.0
    paper_variance: bool = True
    latent_init: bool = True      # False -> D2SAC (Gaussian-noise init)


def run_reverse_chain(sched: DiffusionSchedule, eps_fn: Callable, x_I, s,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      paper_variance: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full reverse chain.  ``eps_fn(x, i, s) -> eps`` is the LADN.

    ``noise`` is ``(I,) + x_I.shape``; when it is None it is drawn from
    ``generator``.  Returns (x_0, softmax(x_0)).  Differentiable end to
    end (reparameterised noise)."""
    I = sched.num_steps  # noqa: E741
    if noise is None:
        noise = torch.randn((I,) + tuple(x_I.shape), generator=generator,
                            device=x_I.device)
    x = x_I
    for step in range(I):
        i = I - step                      # I, I-1, ..., 1
        x = reverse_step(sched, eps_fn(x, i, s), x, i, noise[step],
                         paper_variance=paper_variance)
    return x, torch.softmax(x, dim=-1)
