"""LAD-TS's acting step in plain PyTorch (paper §IV-A, Eqns 8, 10, 11).

The latent action is noised to level I (Eqn 11), denoised by I reverse
steps of the LADN (an MLP on [x | sinusoidal step embedding | state],
ReLU between layers, Eqn 10 with the paper's (beta_tilde / 2) noise and
none on the last step), and the action drawn as the argmax of log pi
plus the Gumbel draw.  Float64 here; ``dtype=torch.bfloat16`` is the
check's control, every product and update rounded to bfloat16.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

TIME_EMBED_DIM = 16


def schedule(I: int, beta_min: float, beta_max: float,  # noqa: E741
             dtype=torch.float64):
    """betas, lambdas, lambda_bars, beta_tildes for i = 1..I."""
    i = torch.arange(1, I + 1, dtype=torch.float64)
    betas = 1.0 - torch.exp(-beta_min / I - (2 * i - 1) / (2 * I * I)
                            * (beta_max - beta_min))
    lambdas = 1.0 - betas
    bars = torch.cumprod(lambdas, 0)
    prev = torch.cat([torch.ones(1, dtype=torch.float64), bars[:-1]])
    tildes = (1.0 - prev) / (1.0 - bars) * betas
    return tuple(t.to(dtype) for t in (betas, lambdas, bars, tildes))


def step_embed(i: int, dtype) -> torch.Tensor:
    half = TIME_EMBED_DIM // 2
    freqs = torch.exp(-math.log(100.0) * torch.arange(half,
                                                      dtype=torch.float64)
                      / half)
    ang = float(i) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


def denoise(theta: List[Tuple[torch.Tensor, torch.Tensor]],
            latent: torch.Tensor, eps0: torch.Tensor, s: torch.Tensor,
            chain: torch.Tensor, I: int, beta_min: float,  # noqa: E741
            beta_max: float, dtype=torch.float64) -> torch.Tensor:
    """x_0 of one agent's chain: theta [(w (in, out), b (out,))] x 3,
    latent and eps0 (A,), s (S,), chain (I, A) with ``chain[step]`` used
    at i = I - step."""
    betas, lambdas, bars, tildes = schedule(I, beta_min, beta_max, dtype)
    th = [(w.to("cpu", dtype), b.to("cpu", dtype)) for w, b in theta]
    lat, e0, s, chain = (t.to("cpu", dtype) for t in (latent, eps0, s,
                                                        chain))
    x = torch.sqrt(bars[-1]) * lat + torch.sqrt(1 - bars[-1]) * e0
    for step in range(I):
        i = I - step
        h = torch.cat([x, step_embed(i, dtype), s])
        for j, (w, b) in enumerate(th):
            h = h @ w + b
            if j + 1 < len(th):
                h = torch.relu(h)
        k = i - 1
        mean = (x - betas[k] / torch.sqrt(1 - bars[k]) * h) \
            / torch.sqrt(lambdas[k])
        scale = tildes[k] / 2 if i > 1 else torch.zeros((), dtype=dtype)
        x = mean + scale * chain[step]
    return x


def action(x0: torch.Tensor, gumbel: torch.Tensor) -> int:
    """Eqn (8)'s draw: argmax of log softmax(x0) (clipped at 1e-8) plus
    the Gumbel noise."""
    p = torch.softmax(x0.double(), -1)
    return int(torch.argmax(torch.log(p.clamp(min=1e-8))
                            + gumbel.double().cpu()))
