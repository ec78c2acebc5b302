"""Helpers shared by the ``test_torch_*`` parity tests: matching configs,
parameters carried from the JAX package to the port, and a fake clock.

Both packages get the same inputs as numpy arrays; JAX stays on the CPU.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.transformer import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax

CPU = torch.device("cpu")


def configs(num_layers: int = 2, arch: str = "qwen2-1.5b", **overrides):
    """(JAX cfg, port cfg): reduced ``arch``, f32, ``num_layers`` deep."""
    kw = dict(num_layers=num_layers, **overrides)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    return jcfg, tcfg


def params_pair(jcfg, tcfg, seed: int = 0):
    """JAX params from ``seed`` and the port's copy of them on the CPU."""
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(tree, tcfg, CPU)


class FakeClock:
    """Deterministic clock: every read advances by ``dt`` seconds."""

    def __init__(self, dt: float = 1e-3):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def tokens_of(req) -> np.ndarray:
    return np.stack([np.asarray(t).ravel() for t in req.tokens])


def episode_to_torch(ep):
    """The reference's ``EpisodeData`` as the port's, on the CPU."""
    from repro_torch.core.env import EpisodeData
    return EpisodeData(*(torch.from_numpy(np.array(a)) for a in ep))


def agents_to_torch(states, method: str):
    """The reference's stacked agent state as the port's, on the CPU."""
    from repro_torch.convert import agent_states_from_jax
    return agent_states_from_jax(jax.tree_util.tree_map(np.asarray, states),
                                 method)
