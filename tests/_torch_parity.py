"""Helpers shared by the ``test_torch_*`` parity tests: matching configs,
parameters carried from the JAX package to the port, and a fake clock.

Both packages get the same inputs as numpy arrays; JAX stays on the CPU.
The agents' draws are the reference's own (``act_draws``), taken from its
keys and handed to the port.
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
from repro_torch.core import agents as ag

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
                                 method, "cpu")


def chain_draws(key, rows, A, I):  # noqa: E741
    """What ``agents._policy_probs`` draws from ``key`` for ``rows``
    chains (None = one unbatched chain): eps0 and the chain noise."""
    def one(k):
        k_noise, k_chain = jax.random.split(k)
        return (np.asarray(jax.random.normal(k_noise, (A,))),
                np.asarray(jax.random.normal(k_chain, (I, A))))
    if rows is None:
        return [x[None] for x in one(key)]
    pairs = [one(k) for k in jax.random.split(key, rows)]
    return [np.stack(x) for x in zip(*pairs)]


def act_draws(method, keys, A, I):  # noqa: E741
    """The reference's act draws for each agent's key, as the port's
    noise dict."""
    per = []
    for k in keys:
        if method in ("lad-ts", "d2sac-ts"):
            k_chain, k_samp = jax.random.split(k)
            eps0, chain = chain_draws(k_chain, None, A, I)
            per.append({"eps0": eps0, "chain": chain,
                        "gumbel": np.asarray(jax.random.gumbel(k_samp,
                                                               (A,))),
                        "x_used": np.asarray(jax.random.normal(
                            jax.random.fold_in(k, 7), (A,)))})
        elif method == "sac-ts":
            per.append({"gumbel": np.asarray(jax.random.gumbel(k, (A,)))})
        else:
            k1, k2 = jax.random.split(k)
            per.append({"rand_a": np.asarray(jax.random.randint(k1, (), 0,
                                                                A)),
                        "u": np.asarray(jax.random.uniform(k2))})
    out = {name: torch.from_numpy(np.stack([d[name] for d in per]))
           for name in per[0]}
    if "eps0" in out:
        out["chain"] = ag.ChainNoise(out.pop("eps0"), out["chain"])
    if "rand_a" in out:
        out["rand_a"] = out["rand_a"].long()
    return out
