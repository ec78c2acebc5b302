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
per state and vmaps the slots).

On a mesh the mLSTM is tensor-parallel over "model" where M divides
``head_dim``: the reference's ``state_pspecs`` cuts ``C`` (B, H, hd, hd)
and ``n`` (B, H, hd) on dim 2, so rank j holds rows [j hd / M,
(j + 1) hd / M) of every head's ``C`` and ``n`` (see ``_MlstmRows``,
whose share is every row without a mesh).
The sLSTM computes whole on every "model" rank (its placed weights
all-gathered before use): its recurrence mixes the full width at every
step, so a cut would all-gather h at every prompt step.
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


class _MlstmRows:
    """A rank's share of the mLSTM: rows [lo, lo + c) of every head's hd.

    The cell writes ``C[i, j] = f C[i, j] + i_g v_i k_j`` and reads
    ``num_i = sum_j C[i, j] q_j`` and ``den = sum_j n_j q_j`` with
    ``n_j = f n_j + i_g k_j``: dim 2 of ``C`` is v's index and dim 2 of
    ``n`` is k's.  Where the current context cuts the states over "model"
    (M divides ``head_dim``, as ``state_pspecs`` requires) c = hd / M:
    the rank's rows of ``C`` need its rows of v and all of k and q, its
    rows of ``n`` its rows of k, and ``den`` is a partial dot, all-reduced
    over "model" (a (B, H) tensor a step; a prompt's are all-reduced at
    once after its loop, as no step reads them).  The projections are
    all-gathered before use: q and k must be whole, and the rank's rows
    of v, of the ``z`` gate and of ``w_down``'s input are a strided slice
    of every head (a column cut of ``w_up``'s (d, 2d) falls across its
    ``[z | y]`` halves, and y feeds q and k whole, so the port gathers
    ``w_up`` rather than re-laying its halves out, and takes the rank's
    rows of z from the whole product).  ``w_down``'s product is a partial
    sum over the rank's rows, reduced over "model".

    Without a context, or where the states are whole over "model", the
    share is every row (lo 0, c hd) and ``axes`` is empty: nothing is
    reduced and each rank's gradients are whole."""

    def __init__(self, cfg):
        ctx = sharding.current()
        self.mesh = ctx.mesh if ctx is not None else None
        self.H, self.hd = cfg.num_heads, cfg.head_dim
        M = self.mesh.shape.get("model", 0) if self.mesh is not None else 0
        cut = M > 0 and self.hd % M == 0
        self.axes = ("model",) if cut else ()
        self.c = self.hd // M if cut else self.hd
        self.lo = self.mesh.local_rank("model") * self.c if cut else 0

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (..., hd) at this rank's rows of the last dim."""
        return t if self.c == self.hd else t[..., self.lo:self.lo + self.c]

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (..., H * hd) at this rank's rows of every head: (...,
        H * c)."""
        if self.c == self.hd:
            return t
        lead = t.shape[:-1]
        return self.rows(t.reshape(*lead, self.H, self.hd)).reshape(
            *lead, self.H * self.c)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` into the rank's share, its gradient summed over
        ``axes``."""
        return sharding.enter(t, self.mesh, self.axes) if self.axes else t

    def params(self, p, cfg) -> dict:
        """The rank's view of the block's params: its projections
        gathered whole (``v``'s columns and ``w_down``'s rows cut to its
        rows of every head), the replicated gates entered."""
        d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        w = {name: sharding.weight(p[name], name, shape,
                                   partial=bool(self.axes))
             for name, shape in (("w_up", (d, 2 * d)), ("wq", (d, H * hd)),
                                 ("wk", (d, H * hd)), ("wv", (d, H * hd)),
                                 ("w_down", (d, d)))}
        w_down = w["w_down"]
        if self.c != hd:
            w_down = w_down.reshape(H, hd, d)[:, self.lo:self.lo + self.c]
            w_down = w_down.reshape(H * self.c, d)
        q = {"w_up": w["w_up"], "wq": w["wq"], "wk": w["wk"],
             "wv": self.cols(w["wv"]), "w_down": w_down}
        for name in ("wi", "wf", "bf"):
            q[name] = self.enter(p[name])
        return q


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


def _mlstm_cell(state, ins, rk: _MlstmRows):
    """One stabilised mLSTM step on rank ``rk``'s rows: ``C`` (B, H, c,
    hd), ``n`` (B, H, c), ``m`` (B, H); q, k (B, H, hd) whole, v
    (B, H, c) the rank's rows.  Returns the new state, the rank's rows of
    the numerator (B, H, c) and its partial of the normaliser's dot
    (B, H)."""
    C, n, m = state
    q, k, v, i_t, f_t = ins
    m_new = torch.maximum(f_t + m, i_t)
    f_p = torch.exp(f_t + m - m_new)[..., None]
    i_p = torch.exp(i_t - m_new)[..., None]
    C_new = f_p[..., None] * C + i_p[..., None] * (v[..., :, None]
                                                   * k[..., None, :])
    n_new = f_p * n + i_p * rk.rows(k)
    num = torch.einsum("bhij,bhj->bhi", C_new, q)
    den = torch.einsum("bhj,bhj->bh", n_new, rk.rows(q))
    return (C_new, n_new, m_new), num, den


def _mlstm_qkv(p, cfg, x, rk: _MlstmRows):
    """x (B, ..., d) -> z (B, ..., H c), q, k (B, ..., H, hd) and v
    (B, ..., H, c) in f32 (k scaled by 1/sqrt(hd) in x's dtype) and the
    f32 gates (B, ..., H), from the rank's view ``p``
    (``_MlstmRows.params``)."""
    H, hd = cfg.num_heads, cfg.head_dim
    z, y = (x @ p["w_up"]).chunk(2, dim=-1)
    z = rk.cols(z)
    lead = y.shape[:-1]
    q = (y @ p["wq"]).reshape(*lead, H, hd)
    k = (y @ p["wk"]).reshape(*lead, H, hd) / torch.tensor(
        float(hd), dtype=y.dtype, device=y.device).sqrt()
    v = (y @ p["wv"]).reshape(*lead, H, rk.c)
    yf = y.float()
    return (z, q.float(), k.float(), v.float(), yf @ p["wi"],
            yf @ p["wf"] + p["bf"])


def _mlstm_out(p, rk: _MlstmRows, num, den, z, dtype):
    """The block's output from the rank's numerators (B, ..., H, c) and
    its normaliser partials (B, ..., H): the partials all-reduced over
    ``axes``, h its rows, ``w_down``'s partial product reduced."""
    if rk.axes:
        den = sharding.all_reduce(den, rk.mesh, rk.axes)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    h = h.reshape(*h.shape[:-2], -1).to(dtype)
    out = (h * F.silu(z)) @ p["w_down"]
    return sharding.reduce(out, rk.mesh, rk.axes) if rk.axes else out


def mlstm_scan(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B, S, d) -> ((B, S, d), final state); on a mesh that cuts the
    states the state is the rank's rows (``_MlstmRows``)."""
    rk = _MlstmRows(cfg)
    B, S, _ = x.shape
    p = rk.params(p, cfg)
    x = rk.enter(x)
    z, q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, x, rk)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    state = (zeros(B, rk.H, rk.c, rk.hd), zeros(B, rk.H, rk.c),
             zeros(B, rk.H))
    nums, dens = [], []
    for t in trips(S):
        state, num, den = _mlstm_cell(
            state, (q[:, t], k[:, t], v[:, t], i_t[:, t], f_t[:, t]), rk)
        nums.append(num)
        dens.append(den)
    out = _mlstm_out(p, rk, torch.stack(fill(nums, S), dim=1),
                     torch.stack(fill(dens, S), dim=1), z, x.dtype)
    C, n, m = state
    return out, {"C": C, "n": n, "m": m,
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}


def mlstm_step(p, cfg, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d), state -> (out (B, 1, d), new state); on a mesh that
    cuts the states ``state`` is the rank's rows."""
    rk = _MlstmRows(cfg)
    p = rk.params(p, cfg)
    z, q, k, v, i_t, f_t = _mlstm_qkv(p, cfg, rk.enter(x[:, 0]), rk)
    (C, n, m), num, den = _mlstm_cell(
        (state["C"], state["n"], state["m"]), (q, k, v, i_t, f_t), rk)
    out = _mlstm_out(p, rk, num, den, z, x.dtype)[:, None]
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
