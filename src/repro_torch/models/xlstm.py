"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro/models/xlstm.py`` (arXiv:2405.04517 at the cell level:
exponential gating with the max-stabiliser).  Params keep the reference's
keys and ``(in, out)`` layouts; gates and states are f32 whatever the
model dtype, as in the reference.  Both cells expose

* ``*_scan``: the prompt's recurrence, a Python loop over positions (the
  reference's ``lax.scan``, step by step), and
* ``*_step``: one decode token.

States carry a leading batch (slot) axis and a ``pos`` (B,) int32, as
the port's other layer states do (the reference keeps a scalar ``pos``
per state and vmaps the slots).  On a mesh the cells compute whole on
every rank: their placed weights are all-gathered before use, and their
states take the slot cut only.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding
from repro_torch.models.layers import dense_init
from repro_torch.roofline.hooks import fill, trips

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_whole(p, cfg) -> dict:
    """``p`` with its projections whole: on a mesh the cells compute whole
    on every rank (``launch.sharding.whole``)."""
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    return sharding.whole(p, {"w_up": (d, 2 * d), "wq": (d, hd),
                              "wk": (d, hd), "wv": (d, hd), "w_down": (d, d)})



def init_mlstm(generator: torch.Generator, cfg, dtype: torch.dtype,
               device: torch.device) -> dict:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "w_up": dense_init(generator, d, 2 * d, dtype, device),  # [z | y]
        "wq": dense_init(generator, d, H * hd, dtype, device),
        "wk": dense_init(generator, d, H * hd, dtype, device),
        "wv": dense_init(generator, d, H * hd, dtype, device),
        # scalar gates per head, f32
        "wi": dense_init(generator, d, H, torch.float32, device),
        "wf": dense_init(generator, d, H, torch.float32, device),
        "bf": torch.full((H,), 3.0, dtype=torch.float32, device=device),
        "w_down": dense_init(generator, d, d, dtype, device),
    }


def init_mlstm_state(cfg, batch: int, device: torch.device) -> dict:
    H, hd = cfg.num_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": zeros(batch, H, hd, hd), "n": zeros(batch, H, hd),
            "m": zeros(batch, H),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mlstm_cell(state, qkv_if):
    """One stabilised mLSTM step; every input is one position (B, ...)."""
    C, n, m = state
    q, k, v, i_t, f_t = qkv_if            # q, k, v (B, H, hd); gates (B, H)
    m_new = torch.maximum(f_t + m, i_t)
    f_p = torch.exp(f_t + m - m_new)[..., None]
    i_p = torch.exp(i_t - m_new)[..., None]
    C_new = f_p[..., None] * C + i_p[..., None] * (v[..., :, None]
                                                   * k[..., None, :])
    n_new = f_p * n + i_p * k
    num = torch.einsum("bhij,bhj->bhi", C_new, q)
    den = torch.clamp(torch.einsum("bhj,bhj->bh", n_new, q).abs(), min=1.0)
    return (C_new, n_new, m_new), num / den[..., None]


def _mlstm_qkv(p, cfg, y):
    """y (B, ..., d) -> q, k, v (B, ..., H, hd) in y's dtype (k scaled by
    1/sqrt(hd) in that dtype) and the f32 gates (B, ..., H)."""
    H, hd = cfg.num_heads, cfg.head_dim
    shape = (*y.shape[:-1], H, hd)
    q = (y @ p["wq"]).reshape(shape)
    k = (y @ p["wk"]).reshape(shape) / torch.tensor(
        float(hd), dtype=y.dtype, device=y.device).sqrt()
    v = (y @ p["wv"]).reshape(shape)
    yf = y.float()
    return q, k, v, yf @ p["wi"], yf @ p["wf"] + p["bf"]


def mlstm_scan(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> ((B, S, d), final state)."""
    p = _mlstm_whole(p, cfg)
    B, S, d = x.shape
    z, y = (x @ p["w_up"]).chunk(2, dim=-1)
    q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, y)
    q, k, v = q.float(), k.float(), v.float()
    st = init_mlstm_state(cfg, B, x.device)
    state = (st["C"], st["n"], st["m"])
    hs = []
    for t in trips(S):
        state, h = _mlstm_cell(state, (q[:, t], k[:, t], v[:, t],
                                       i_t[:, t], f_t[:, t]))
        hs.append(h)
    h = torch.stack(fill(hs, S), dim=1).reshape(B, S, d).to(x.dtype)
    C, n, m = state
    new = {"C": C, "n": n, "m": m,
           "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return (h * F.silu(z)) @ p["w_down"], new


def mlstm_step(p, cfg, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d), state -> (out (B, 1, d), new state)."""
    p = _mlstm_whole(p, cfg)
    B, _, d = x.shape
    z, y = (x[:, 0] @ p["w_up"]).chunk(2, dim=-1)
    q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, y)
    (C, n, m), h = _mlstm_cell((state["C"], state["n"], state["m"]),
                               (q.float(), k.float(), v.float(), i_t, f_t))
    h = h.reshape(B, d).to(x.dtype)
    out = ((h * F.silu(z)) @ p["w_down"])[:, None]
    return out, {"C": C, "n": n, "m": m, "pos": state["pos"] + 1}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
# Full d x d recurrent matrices, as in the reference (the release code uses
# block-diagonal ones); the cell dynamics are the paper's.

_GATES = "ifzo"


def init_slstm(generator: torch.Generator, cfg, dtype: torch.dtype,
               device: torch.device) -> dict:
    d = cfg.d_model
    p = {f"w_{g}": dense_init(generator, d, d, dtype, device)
         for g in _GATES}
    p.update({f"r_{g}": dense_init(generator, d, d, dtype, device)
              for g in _GATES})
    p["bf"] = torch.full((d,), 3.0, dtype=torch.float32, device=device)
    p["w_out"] = dense_init(generator, d, d, dtype, device)
    return p


def init_slstm_state(cfg, batch: int, device: torch.device) -> dict:
    d = cfg.d_model
    st = {name: torch.zeros((batch, d), dtype=torch.float32, device=device)
          for name in ("c", "n", "h", "m")}
    st["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return st


def _slstm_whole(p, cfg) -> dict:
    d = cfg.d_model
    return sharding.whole(p, {"w_z": (d, d), "w_out": (d, d)})


def _gate_weights(p, kind: str) -> torch.Tensor:
    """The four gates' ``w_*`` or ``r_*`` side by side, f32: (d, 4d)."""
    return torch.cat([p[f"{kind}_{g}"] for g in _GATES], dim=1).float()


def _slstm_cell(p, state, x_pre: torch.Tensor, r: torch.Tensor):
    """One step.  ``x_pre`` (B, 4d) is the position's f32 input projection
    through the four ``w_*`` gates, ``r`` (d, 4d) the recurrent ones."""
    c, n, h, m = state
    pre = x_pre + h @ r
    i_t, f_t, z_t, o_t = pre.chunk(4, dim=-1)
    f_t = f_t + p["bf"]
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_scan(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> ((B, S, d), final state).  The input projections of
    every position are one product ahead of the loop."""
    p = _slstm_whole(p, cfg)
    B, S, d = x.shape
    x_pre = x.float() @ _gate_weights(p, "w")            # (B, S, 4d)
    r = _gate_weights(p, "r")
    st = init_slstm_state(cfg, B, x.device)
    state = (st["c"], st["n"], st["h"], st["m"])
    hs = []
    for t in trips(S):
        state, h = _slstm_cell(p, state, x_pre[:, t], r)
        hs.append(h)
    h = torch.stack(fill(hs, S), dim=1).to(x.dtype)
    c, n, h_f, m = state
    new = {"c": c, "n": n, "h": h_f, "m": m,
           "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return h @ p["w_out"], new


def slstm_step(p, cfg, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d), state -> (out (B, 1, d), new state)."""
    p = _slstm_whole(p, cfg)
    x_pre = x[:, 0].float() @ _gate_weights(p, "w")
    (c, n, h, m), h_new = _slstm_cell(
        p, (state["c"], state["n"], state["h"], state["m"]), x_pre,
        _gate_weights(p, "r"))
    out = (h_new.to(x.dtype) @ p["w_out"])[:, None]
    return out, {"c": c, "n": n, "h": h, "m": m, "pos": state["pos"] + 1}
