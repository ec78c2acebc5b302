"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU.

Port of ``repro/models/rglru.py``.  Block structure (arXiv:2402.19427):

    x -> [gate branch: W_gate -> GeLU] ---------------------\\
    x -> [main branch: W_in -> causal depthwise conv1d       * -> W_out
          -> RG-LRU diagonal recurrence] --------------------/

RG-LRU, all diagonal / elementwise:
    r_t = sigmoid(block_diag(W_a) u_t)          recurrence gate
    i_t = sigmoid(block_diag(W_x) u_t)          input gate
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The prompt's recurrence is a Python loop over time, as the reference's
``lax.scan`` is sequential, or, with ``use_assoc_scan`` (the reference's
``lax.associative_scan``), a log-depth prefix scan over the (a, b) pairs:
ceil(log2 S) vectorised steps.  States carry a leading batch (slot) axis: ``h`` (B, rd) f32,
``conv`` (B, conv1d_width - 1, rd) f32 and ``pos`` (B,) int32.

On a mesh the block computes whole on every rank: its placed
projections are all-gathered before use, and its states take the slot
cut only.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding
from repro_torch.models.layers import dense_init
from repro_torch.roofline.hooks import fill, trips

_C = 8.0
_NBLOCKS = 8  # block-diagonal gate projections, as in Griffin


def init_rglru(generator: torch.Generator, cfg, dtype: torch.dtype,
               device: torch.device) -> dict:
    """Random RG-LRU params drawn from ``generator``; the gate weights and
    Lambda stay f32 whatever the model dtype, as in the reference."""
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    bs = rd // _NBLOCKS

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    return {
        "w_in": dense_init(generator, d, rd, dtype, device),
        "w_gate_in": dense_init(generator, d, rd, dtype, device),
        "w_out": dense_init(generator, rd, d, dtype, device),
        "conv_w": (normal((cfg.conv1d_width, rd)) * 0.1).to(dtype),
        "conv_b": torch.zeros((rd,), dtype=dtype, device=device),
        "gate_a": normal((_NBLOCKS, bs, bs)) * bs ** -0.5,
        "gate_x": normal((_NBLOCKS, bs, bs)) * bs ** -0.5,
        # Lambda so that a ~ U[0.9, 0.999] at r = 1 (Griffin appendix)
        "lam": 2.0 + 3.0 * torch.rand((rd,), generator=generator,
                                      dtype=torch.float32, device=device),
    }


def init_rglru_state(cfg, batch: int, device: torch.device) -> dict:
    rd = cfg.rg_lru_dim or cfg.d_model
    return {
        "h": torch.zeros((batch, rd), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, rd),
                            dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _mesh_weights(p: dict, cfg) -> dict:
    """``p`` with its projections whole: on a mesh the block computes whole
    on every rank, so each placed projection is all-gathered before use
    (``launch.sharding.whole``)."""
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    return sharding.whole(p, {"w_in": (d, rd), "w_gate_in": (d, rd),
                              "w_out": (rd, d)})


def _block_diag(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., rd) @ block_diag(w (nb, bs, bs)) -> (..., rd), float32."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    out = torch.einsum("...nb,nbc->...nc", xs.float(), w)
    return out.reshape(x.shape)


def _gates(p: dict, u: torch.Tensor):
    """u (..., rd) float32 -> (a, gated input b) elementwise terms."""
    r = torch.sigmoid(_block_diag(p["gate_a"], u))
    i = torch.sigmoid(_block_diag(p["gate_x"], u))
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)
    return a, b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _conv1d(p: dict, u: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, rd), in u's dtype."""
    W = p["conv_w"].shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(W))
    return out + p["conv_b"]


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All h_t of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1 by
    recursive doubling: after the step at distance d each (a_t, b_t)
    holds the combine of the pairs t - 2d + 1 .. t, with the reference's
    combine (a_l a_r, b_l a_r + b_r) of an earlier pair l and a later r."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d],
                                               a[:, d:])], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan(p: dict, cfg, x: torch.Tensor, *,
               use_assoc_scan: bool = False) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> ((B, S, d), final state).  The conv runs in the
    model dtype and the recurrence in f32, as in the reference; the
    recurrence is the time loop, or with ``use_assoc_scan`` the log-depth
    prefix scan.  Serving's loop writes each h_t in place; with a
    gradient to take, it stacks them instead."""
    p = _mesh_weights(p, cfg)
    gate = _gelu(x @ p["w_gate_in"])
    u_raw = (x @ p["w_in"]).float()
    u = _conv1d(p, u_raw.to(x.dtype)).float()
    a, b = _gates(p, u)
    B, S, rd = u.shape
    if use_assoc_scan:
        hs = _prefix_scan(a, b)
    elif torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        # autograd refuses ``out=``: keep each h_t and stack them
        h = torch.zeros((B, rd), dtype=torch.float32, device=x.device)
        steps = []
        for t in trips(S):
            h = torch.addcmul(b[:, t], a[:, t], h)
            steps.append(h)
        hs = torch.stack(fill(steps, S), dim=1)
    else:
        hs = torch.empty((B, S, rd), dtype=torch.float32, device=x.device)
        h = torch.zeros((B, rd), dtype=torch.float32, device=x.device)
        for t in trips(S):             # h_t = a_t * h_{t-1} + b_t
            h = torch.addcmul(b[:, t], a[:, t], h, out=hs[:, t])
    out = hs.to(x.dtype) * gate
    Wc = p["conv_w"].shape[0]
    conv_hist = F.pad(u_raw, (0, 0, Wc - 1, 0))[:, S:S + Wc - 1]
    state = {"h": hs[:, -1].clone(), "conv": conv_hist.contiguous(),
             "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return out @ p["w_out"], state


def rglru_step(p: dict, cfg, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, d); the conv runs in f32 over the
    rolling buffer of the last (W - 1) inputs."""
    p = _mesh_weights(p, cfg)
    xt = x[:, 0]
    gate = _gelu(xt @ p["w_gate_in"])
    u_in = (xt @ p["w_in"]).float()
    hist = torch.cat([state["conv"], u_in[:, None]], dim=1)
    W = p["conv_w"].shape[0]
    u = sum(hist[:, i] * p["conv_w"][i].float() for i in range(W))
    u = u + p["conv_b"].float()
    a, b = _gates(p, u)
    h = a * state["h"] + b
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    new_state = {"h": h, "conv": hist[:, 1:], "pos": state["pos"] + 1}
    return out[:, None], new_state
