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


def yarn_freqs(head_dim: int, rope, device: torch.device) -> torch.Tensor:
    """Yarn's inverse frequencies (Hugging Face's
    ``_compute_yarn_parameters``, ``truncate`` on), shape (head_dim // 2,),
    for ``rope`` (a ``configs.base.RopeSpec``: theta, factor s, original
    positions L, beta_fast, beta_slow):

        f_i     = theta ** (-2i / hd)                  (extrapolated)
        dim(r)  = hd * ln(L / (2 pi r)) / (2 ln theta)
        lo, hi  = max(floor(dim(beta_fast)), 0),
                  min(ceil(dim(beta_slow)), hd - 1)    (hi += 0.001 if equal)
        ramp_i  = clamp((i - lo) / (hi - lo), 0, 1)
        inv_i   = f_i / s * ramp_i + f_i * (1 - ramp_i)

    Low dims (fast rotations) keep their frequency, high dims are
    interpolated by s."""
    def dim(rotations):
        return (head_dim * math.log(rope.original_max_position
                                    / (rotations * 2 * math.pi))
                / (2 * math.log(rope.theta)))

    lo = max(math.floor(dim(rope.beta_fast)), 0)
    hi = min(math.ceil(dim(rope.beta_slow)), head_dim - 1)
    if lo == hi:
        hi += 0.001
    extra = rope_freqs(head_dim, rope.theta, device)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    return extra / rope.factor * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, rope=None) -> torch.Tensor:
    """Rotary embedding in the half-split layout of the reference:
    ``concat([x1*cos - x2*sin, x2*cos + x1*sin])``.

    x: (..., seq, heads, head_dim); positions: (..., seq) or (seq,).
    ``rope`` (a ``configs.base.RopeSpec``) replaces ``theta``: its own
    theta for ``default``, or :func:`yarn_freqs` with cos and sin times
    its ``attention_factor`` (each score then scaled by its square).
    """
    head_dim = x.shape[-1]
    scale = 1.0
    if rope is None:
        freqs = rope_freqs(head_dim, theta, x.device)
    elif rope.kind == "default":
        freqs = rope_freqs(head_dim, rope.theta, x.device)
    elif rope.kind == "yarn":
        freqs = yarn_freqs(head_dim, rope, x.device)
        scale = rope.attention_factor
    else:
        raise ValueError(f"unknown RoPE kind {rope.kind!r}")
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., :, None, :]                       # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    if scale != 1.0:
        sin, cos = sin * scale, cos * scale
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
