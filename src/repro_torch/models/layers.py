"""Shared neural-net layers: norms, rotary and sinusoidal positions, MLPs.

Port of ``repro/models/layers.py``.  Params are plain dicts of tensors with
the reference's keys and its ``(in, out)`` weight layout, so ``x @ w``
reads the same in both packages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, 1/in_dim) weights drawn in f32 from ``generator`` (which must
    live on ``device``), then cast."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_rmsnorm(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding in the half-split layout of the reference:
    ``concat([x1*cos - x2*sin, x2*cos + x1*sin])``.

    x: (..., seq, heads, head_dim); positions: (..., seq) or (seq,).
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., :, None, :]                       # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """Classic transformer sinusoidal table, f32: positions (...,) ->
    (..., d_model), ``[sin | cos]`` halves.  The caller casts it to the
    model dtype."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, dtype: torch.dtype, device: torch.device) -> dict:
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype, device),
         "w_down": dense_init(generator, d_ff, d_model, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype, device)
    return p


def apply_mlp(p: dict, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """Dense MLP.  Gated -> SwiGLU; non-gated -> tanh-approximated GELU
    (what ``jax.nn.gelu`` computes by default).

    Inside a mesh's ``ShardingContext`` the weights are this rank's
    placed blocks (``d_ff`` gives their global shapes): FSDP's "data"
    cuts are all-gathered, and where "model" cuts ``d_ff`` the MLP is
    tensor-parallel (``w_up`` / ``w_gate`` column-parallel, ``w_down``
    row-parallel, one all-reduce of the output over "model")."""
    d = x.shape[-1]
    tp = sharding.splits("w_up", (d, d_ff))
    keep = ("model",) if tp else ()
    if tp:
        mesh = sharding.current().mesh
        x = sharding.enter(x, mesh, ("model",))
    up = x @ sharding.weight(p["w_up"], "w_up", (d, d_ff), keep=keep)
    if "w_gate" in p:
        gate = x @ sharding.weight(p["w_gate"], "w_gate", (d, d_ff),
                                   keep=keep)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    y = h @ sharding.weight(p["w_down"], "w_down", (d_ff, d), keep=keep)
    return sharding.reduce(y, mesh, ("model",)) if tp else y
