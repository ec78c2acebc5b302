"""Fixed-capacity circular experience pool (paper: |R| = 1000), one per
ES agent.

Port of ``repro/core/replay.py``.  The B agents' pools are stacked: every
buffer is ``(G, capacity, ...)`` and ``ptr``/``size`` are ``(G,)``.
Updates are functional (a new state is returned) and masked per agent, so
the trainer's loop needs no host sync.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.optim import tree_leaves, tree_map


class ReplayState(NamedTuple):
    data: Any              # pytree of (G, capacity, ...) tensors
    ptr: torch.Tensor      # (G,) int64 next write slot
    size: torch.Tensor     # (G,) int64 number of valid entries


def replay_init(capacity: int, item_spec, num_agents: int,
                device=None) -> ReplayState:
    """``item_spec``: a tree of tensors shaped like one item."""
    data = tree_map(lambda s: torch.zeros((num_agents, capacity)
                                          + tuple(s.shape), dtype=s.dtype,
                                          device=device), item_spec)
    z = torch.zeros((num_agents,), dtype=torch.int64, device=device)
    return ReplayState(data=data, ptr=z, size=z.clone())


def replay_add(state: ReplayState, item, valid: torch.Tensor
               ) -> ReplayState:
    """Append each agent's ``item`` (leaves ``(G, ...)``) where its
    ``valid`` flag (``(G,)`` bool) is set."""
    cap = tree_leaves(state.data)[0].shape[1]
    rows = torch.arange(valid.shape[0], device=valid.device)

    def write(buf, x):
        cur = buf[rows, state.ptr]
        v = valid.reshape((-1,) + (1,) * (x.dim() - 1))
        return buf.index_put((rows, state.ptr),
                             torch.where(v, x.to(buf.dtype), cur))

    inc = valid.to(torch.int64)
    return ReplayState(data=tree_map(write, state.data, item),
                       ptr=(state.ptr + inc) % cap,
                       size=torch.clamp(state.size + inc, max=cap))


def sample_indices(state: ReplayState, batch: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Uniform ``(G, batch)`` indices into each agent's valid prefix."""
    hi = torch.clamp(state.size, min=1)
    u = torch.rand((hi.shape[0], batch), generator=generator,
                   device=hi.device)
    idx = (u * hi[:, None].to(torch.float32)).to(torch.int64)
    return torch.minimum(idx, hi[:, None] - 1)


def replay_sample(state: ReplayState, batch: int,
                  generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None):
    """Uniform sample of ``batch`` items per agent from the valid prefix.

    ``idx`` ``(G, batch)`` is drawn from ``generator`` when not given."""
    if idx is None:
        idx = sample_indices(state, batch, generator)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda buf: buf[rows, idx], state.data)
