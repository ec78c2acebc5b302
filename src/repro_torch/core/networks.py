"""Networks for LAD-TS and baselines (paper §IV-A, Fig. 4).

Port of ``repro/core/networks.py``.  The reference builds one agent's tiny
MLPs (two hidden layers of 20 units) and vmaps them over the B per-ES
agents.  Here every parameter carries the agent axis G in front — weights
``(G, in, out)`` and biases ``(G, out)``, under the reference's
``[{"w", "b"}, ...]`` keys — and a layer is one ``torch.baddbmm`` for all
agents.  Inputs are ``(G, ..., in)``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

TIME_EMBED_DIM = 16


def _linear_init(generator, nin: int, nout: int, num_agents: int,
                 device) -> dict:
    lim = 1.0 / math.sqrt(nin)

    def u(shape):
        r = torch.rand(shape, generator=generator, device=device)
        return r * (2 * lim) - lim

    return {"w": u((num_agents, nin, nout)), "b": u((num_agents, nout))}


def init_mlp(generator, dims: Sequence[int], num_agents: int,
             device=None) -> list:
    """U(-1/sqrt(in), 1/sqrt(in)) weights for ``num_agents`` stacked
    agents."""
    return [_linear_init(generator, dims[i], dims[i + 1], num_agents, device)
            for i in range(len(dims) - 1)]


def apply_mlp(params: list, x: torch.Tensor) -> torch.Tensor:
    """x (G, ..., in) -> (G, ..., out): ReLU between layers."""
    lead = x.shape[:-1]
    h = x.reshape(x.shape[0], -1, x.shape[-1])
    for i, layer in enumerate(params):
        h = torch.baddbmm(layer["b"][:, None, :], h, layer["w"])
        if i + 1 < len(params):
            h = torch.relu(h)
    return h.reshape(*lead, h.shape[-1])


def timestep_embed(i, dim: int = TIME_EMBED_DIM, device=None
                   ) -> torch.Tensor:
    """Sinusoidal encoding of the denoising step index (Fig. 4).

    ``i`` is a Python number (-> (dim,)) or a tensor (-> (..., dim)) on
    ``device``; nothing is copied from the host."""
    half = dim // 2
    freqs = torch.exp(-math.log(100.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    if torch.is_tensor(i):
        ang = i.to(device=device, dtype=torch.float32)[..., None] * freqs
    else:
        ang = float(i) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# LADN: eps_theta(x_i, i, s)
# ---------------------------------------------------------------------------


def init_ladn(generator, state_dim: int, action_dim: int,
              hidden: Tuple[int, ...] = (20, 20), num_agents: int = 1,
              device=None) -> list:
    nin = action_dim + TIME_EMBED_DIM + state_dim
    return init_mlp(generator, (nin, *hidden, action_dim), num_agents,
                    device)


def apply_ladn(params: list, x: torch.Tensor, i: int, s: torch.Tensor
               ) -> torch.Tensor:
    """x (G, ..., A), step index i (int), s (G, ..., S) -> eps (G, ..., A).

    Input order [x | time-embed | state], as in the reference."""
    t = timestep_embed(i, device=x.device)
    t = t.expand(*x.shape[:-1], TIME_EMBED_DIM)
    return apply_mlp(params, torch.cat([x, t, s], dim=-1))


# ---------------------------------------------------------------------------
# Critic: Q(s) -> R^A (discrete-action double critic)
# ---------------------------------------------------------------------------


def init_critic(generator, state_dim: int, action_dim: int,
                hidden: Tuple[int, ...] = (20, 20), num_agents: int = 1,
                device=None) -> list:
    return init_mlp(generator, (state_dim, *hidden, action_dim), num_agents,
                    device)


def apply_critic(params: list, s: torch.Tensor) -> torch.Tensor:
    return apply_mlp(params, s)
