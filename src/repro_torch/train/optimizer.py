"""AdamW for LM training: warm-up, cosine schedule, global-norm clipping
and decoupled weight decay on matrices.

Port of ``repro/train/optimizer.py``, functional as the reference is:
``init(params) -> state`` and ``update(cfg, grads, state, params) ->
(params, state, metrics)``, over the port's parameter tree (nested dicts
and lists of tensors).  The moments are f32 and shaped like the params;
each leaf is updated in f32 and cast back to its dtype.  Plain PyTorch:
the reference has no kernel here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.optim import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, then a cosine down to
    ``min_lr_ratio`` of it at ``total_steps``; f32 as in the reference."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (cfg.min_lr_ratio
                                       + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, shards=None, mesh=None) -> torch.Tensor:
    """The f32 L2 norm of every leaf together.  With ``shards`` (per leaf
    of ``tree``, the frozenset of ``mesh`` axes its block is cut on:
    ``launch.sharding.split_axes``) the tree holds this rank's blocks,
    and each leaf's sum of squares is summed over exactly the axes it is
    cut on, never over one it is replicated on."""
    if shards is None:
        leaves = tree_leaves(tree)
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    from repro_torch.launch import sharding
    by_axes: dict = {}

    def add(x, axes):
        sq = torch.sum(torch.square(x.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq

    tree_map(add, tree, shards)
    total = None
    for axes, sq in by_axes.items():   # the same order on every rank
        sq = sq.reshape(1).clone()
        sharding.all_reduce(sq, mesh, sorted(axes))
        total = sq[0] if total is None else total + sq[0]
    return torch.sqrt(total)


def decay_mask(params, cfg):
    """Which leaves of the port's ``params`` the reference decays: those
    of two or more dims in its own layout, where a config that scans its
    layers stacks them on a leading group axis, so a scanned layer's
    vectors (norm scales, biases) count as matrices there."""
    P = len(cfg.pattern)
    n_scan = (cfg.num_layers // P) * P if cfg.scan_layers else 0
    mask = {k: tree_map(lambda p: p.dim() >= 2, v)
            for k, v in params.items() if k != "layers"}
    mask["layers"] = [tree_map(lambda p, s=int(i < n_scan): p.dim() + s >= 2,
                               layer)
                      for i, layer in enumerate(params["layers"])]
    return mask


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           decay=None, shards=None, mesh=None):
    """Returns (new params, new state, metrics {"grad_norm" (before
    clipping), "lr"}).  ``decay`` is a tree of bools shaped like the
    params (which leaves take weight decay); by default those of two or
    more dimensions, as the reference decides on its own layout.  On a
    mesh (``shards``, ``mesh``: see :func:`global_norm`) the trees hold
    this rank's blocks: the update is elementwise, so each rank updates
    its own, and only the norm is summed across ranks."""
    gnorm = global_norm(grads, shards, mesh)
    scale = None
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    t = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)

    def upd(g, m, v, p, wd):
        g32 = g.float()
        if scale is not None:
            g32 = g32 * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if wd:        # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(lambda g, m, v, p, wd: upd(g, m, v, p, wd), grads,
                   state.mu, state.nu, params, decay)

    def part(i):
        return tree_map(lambda g, o: o[i], grads, out)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return part(0), AdamWState(step=step, mu=part(1), nu=part(2)), metrics
