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

On a mesh whose "model" ranks cut ``w_in`` (``launch.sharding``'s
rules), the block is tensor-parallel: rank j computes its rd / M
channels [j rd / M, (j + 1) rd / M) with its column blocks of ``w_in``
and ``w_gate_in``, its channels of ``conv_w``, ``conv_b`` and ``lam``
and its blocks of the block-diagonal gates (where M does not divide
their 8 blocks, the channels a rank's blocks read are all-gathered over
"model" first); the recurrence runs on those channels only, and
``w_out`` is row-parallel, its partial products summed over "model".
The states ``h`` and ``conv`` stay whole over "model", as the
reference's ``state_pspecs`` places them: each rank reads its channels,
and the new ones are all-gathered over "model" once a decode step and
once at the end of a prompt.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    """``p`` with its projections whole: on a mesh whose "model" ranks do
    not cut ``w_in`` the block computes whole on every rank, so each
    placed projection is all-gathered before use
    (``launch.sharding.whole``)."""
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    return sharding.whole(p, {"w_in": (d, rd), "w_gate_in": (d, rd),
                              "w_out": (rd, d)})


class _Channels:
    """This rank's channels [lo, hi) of a tensor-parallel block on
    ``mesh``, and the (nb, bs, bs) gates' blocks [n0, n1) that produce
    them (``gather``: those blocks read channels outside [lo, hi))."""

    def __init__(self, mesh, rd: int):
        self.mesh = mesh
        M = mesh.shape["model"]
        c = rd // M
        self.lo = mesh.local_rank("model") * c
        self.hi = self.lo + c
        bs = rd // _NBLOCKS
        self.n0, self.n1 = self.lo // bs, -(-self.hi // bs)
        self.gather = self.n0 * bs != self.lo or self.n1 * bs != self.hi

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s channels (last dim) of this rank."""
        return t[..., self.lo:self.hi]


def _tp(cfg) -> Optional[_Channels]:
    """This rank's :class:`_Channels` where the current context's
    "model" ranks cut the block's ``w_in``; None otherwise."""
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    if not sharding.splits("w_in", (d, rd)):
        return None
    return _Channels(sharding.current().mesh, rd)


def _rank_params(p: dict, cfg, ch: _Channels) -> dict:
    """Rank ``ch``'s view of ``p``: the column blocks of ``w_in`` /
    ``w_gate_in`` and the row block of ``w_out`` as held ("data"
    gathered), its channels of the replicated ``conv_w`` / ``conv_b`` /
    ``lam`` and its gate blocks, the replicated leaves entered with a
    backward that sums the ranks' partial gradients over "model"."""
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    mesh = ch.mesh
    q = {name: sharding.weight(p[name], name, shape, keep=("model",),
                               partial=True)
         for name, shape in (("w_in", (d, rd)), ("w_gate_in", (d, rd)),
                             ("w_out", (rd, d)))}
    for name in ("conv_w", "conv_b", "lam", "gate_a", "gate_x"):
        t = sharding.enter(p[name], mesh, ("model",))
        q[name] = t[ch.n0:ch.n1] if name.startswith("gate") else ch.mine(t)
    return q


def _block_diag(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., rd) @ block_diag(w (nb, bs, bs)) -> (..., rd), float32."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    out = torch.einsum("...nb,nbc->...nc", xs.float(), w)
    return out.reshape(x.shape)


def _gates(p: dict, u: torch.Tensor, ch=None):
    """u (..., rd) float32 -> (a, gated input b) elementwise terms.  With
    ``ch`` (a tensor-parallel rank), ``u`` is the rank's channels and
    ``p`` its view (``_rank_params``): the gate blocks read the channels
    they cover, all-gathered over "model" where those reach past the
    rank's own."""
    src = u
    if ch is not None and ch.gather:
        bs = p["gate_a"].shape[-1]
        src = sharding.all_gather(u, ch.mesh, "model", -1)[
            ..., ch.n0 * bs:ch.n1 * bs]
    r = torch.sigmoid(_block_diag(p["gate_a"], src))
    i = torch.sigmoid(_block_diag(p["gate_x"], src))
    if ch is not None and ch.gather:
        off = ch.lo - ch.n0 * p["gate_a"].shape[-1]
        r = r[..., off:off + u.shape[-1]]
        i = i[..., off:off + u.shape[-1]]
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


def _enter(x: torch.Tensor, ch) -> torch.Tensor:
    """The block's replicated input; a tensor-parallel rank's cotangents
    of it are partial, summed over "model" by the backward."""
    return x if ch is None else sharding.enter(x, ch.mesh, ("model",))


def _leave(y: torch.Tensor, ch) -> torch.Tensor:
    """The block's output: a tensor-parallel rank's row-parallel partial
    product summed over "model"."""
    return y if ch is None else sharding.reduce(y, ch.mesh, ("model",))


def _whole_over_model(ch, *parts: torch.Tensor):
    """``parts`` (each (B, ..., c), a rank's channels) with every rank's
    channels, in one all-gather over "model"; unchanged without ``ch``."""
    if ch is None:
        return parts
    sizes = [t.shape[1] if t.dim() == 3 else 1 for t in parts]
    flat = torch.cat([t if t.dim() == 3 else t[:, None] for t in parts], 1)
    flat = sharding.all_gather(flat, ch.mesh, "model", -1)
    out = flat.split(sizes, dim=1)
    return tuple(o if t.dim() == 3 else o[:, 0] for o, t in zip(out, parts))


def rglru_scan(p: dict, cfg, x: torch.Tensor, *,
               use_assoc_scan: bool = False, with_state: bool = True
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> ((B, S, d), final state).  The conv runs in the
    model dtype and the recurrence in f32, as in the reference; the
    recurrence is the time loop, or with ``use_assoc_scan`` the log-depth
    prefix scan.  Serving's loop writes each h_t in place; with a
    gradient to take, it stacks them instead.  On a tensor-parallel mesh
    (see the module docstring) every piece runs on this rank's
    channels; the final state (None unless ``with_state``, as a train
    forward needs none) is all-gathered over "model"."""
    ch = _tp(cfg)
    p = _mesh_weights(p, cfg) if ch is None else _rank_params(p, cfg, ch)
    x = _enter(x, ch)
    gate = _gelu(x @ p["w_gate_in"])
    u_raw = (x @ p["w_in"]).float()
    u = _conv1d(p, u_raw.to(x.dtype)).float()
    a, b = _gates(p, u, ch)
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
    out = _leave((hs.to(x.dtype) * gate) @ p["w_out"], ch)
    if not with_state:
        return out, None
    Wc = p["conv_w"].shape[0]
    conv_hist = F.pad(u_raw, (0, 0, Wc - 1, 0))[:, S:S + Wc - 1]
    h_last, conv_hist = _whole_over_model(ch, hs[:, -1], conv_hist)
    state = {"h": h_last.clone(), "conv": conv_hist.contiguous(),
             "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return out, state


def rglru_step(p: dict, cfg, x: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, d); the conv runs in f32 over the
    rolling buffer of the last (W - 1) inputs.  On a tensor-parallel
    mesh the rank steps its channels of the (whole) state, and the new
    ``h`` and conv input are all-gathered over "model" in one call."""
    ch = _tp(cfg)
    p = _mesh_weights(p, cfg) if ch is None else _rank_params(p, cfg, ch)
    xt = _enter(x[:, 0], ch)
    h_prev, conv = state["h"], state["conv"]
    if ch is not None:
        h_prev, conv = ch.mine(h_prev), ch.mine(conv)
    gate = _gelu(xt @ p["w_gate_in"])
    u_in = (xt @ p["w_in"]).float()
    hist = torch.cat([conv, u_in[:, None]], dim=1)
    W = p["conv_w"].shape[0]
    u = sum(hist[:, i] * p["conv_w"][i].float() for i in range(W))
    u = u + p["conv_b"].float()
    a, b = _gates(p, u, ch)
    h = a * h_prev + b
    out = _leave((h.to(x.dtype) * gate) @ p["w_out"], ch)
    if ch is None:
        new_conv = hist[:, 1:]
    else:
        h, u_in = _whole_over_model(ch, h, u_in)
        new_conv = torch.cat([state["conv"][:, 1:], u_in[:, None]], dim=1)
    new_state = {"h": h, "conv": new_conv, "pos": state["pos"] + 1}
    return out[:, None], new_state
