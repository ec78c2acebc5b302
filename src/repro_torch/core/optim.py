"""Small functional Adam for the RL networks (paper Table IV: Adam).

Port of ``repro/core/optim.py``, written out over the stacked parameter
tree instead of ``torch.optim.Adam`` so that its state (the per-agent step
count and the moments) carries across from the reference and an update
matches it exactly.  Every leaf has the agent axis G in front and
``step`` is ``(G,)``: each agent has its own bias correction.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested lists, dicts and
    NamedTuples (``rest`` must share ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[j] for r in rest))
                            for j, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[j] for r in rest))
                          for j, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    step: torch.Tensor      # (G,) int64
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    num_agents = tree_leaves(params)[0].shape[0]
    device = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((num_agents,), dtype=torch.int64,
                                      device=device),
                     mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


def adam_update(params, grads, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    step = state.step + 1
    t = step.to(torch.float32)

    def per_agent(v, like):
        return v.reshape((-1,) + (1,) * (like.dim() - 1))

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    b1c = 1 - torch.pow(b1, t)
    b2c = 1 - torch.pow(b2, t)
    new_params = tree_map(
        lambda p, m, v: p - lr * (m / per_agent(b1c, m))
        / (torch.sqrt(v / per_agent(b2c, v)) + eps),
        params, mu, nu)
    return new_params, AdamState(step=step, mu=mu, nu=nu)
