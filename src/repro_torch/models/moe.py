"""Mixture-of-Experts FFN with capacity-bounded dispatch, and a dropless
grouped path.

Port of ``repro/models/moe.py``.  Three execution paths share the weights
and the capacity semantics:

* ``_apply_moe_local``: one process holds every expert (E, d, f) and
  picks each expert's tokens FIFO up to its capacity; the oracle.

* ``_apply_moe_sharded``: expert parallel over the mesh's "model" ranks
  with no all-to-all.  Activations are replicated on every rank (a step
  that splits its rows over "data" gathers them at the layer's entry),
  so rank
  j takes its token rows (sliced over the data-parallel axes), computes
  the experts it owns on them, and one ``all_reduce`` over "model"
  combines the top-k outputs; an ``all_gather`` over the data axes gives
  every rank all rows back.  Capacity is per token shard
  (C_loc = cf * T_loc * K / E).  With fewer experts E than "model" ranks
  M, the axis factors into (e_par = gcd(E, M), f_par = M / e_par): each
  expert's FFN is column-split over f_par ranks and the same all-reduce
  sums the partial products.

* ``_apply_moe_stationary``: the weights-stationary serving path for
  decode-sized token counts.  The tokens are all-gathered over the data
  axes, each rank multiplies its expert block's slice of the d
  contraction dim ("data"), the partial pre-activations are summed over
  "data" before the nonlinearity, and the outputs (accumulated in f32)
  over "data" and "model".

A config whose ``moe.capacity_factor`` is None is dropless (the port's
own; the reference has none): ``_apply_moe_grouped`` computes every
routed row, outside a mesh.  It routes as the others do, sorts the T x K
assignments by expert on the device, runs one grouped matrix product
(``torch._grouped_mm``, group offsets on the device) for the gate and up
projections together (the ``we_gate_up`` (E, d, 2f) stack such a config
holds; a dropless config is gated), the SiLU gate, one for ``we_down``,
and sums each token's K rows weighted by their gates.  It has no expert
loop and no host sync, so a CUDA graph captures it; its launches are the
same for every routing.  On the card it runs in bf16 only: there torch's
grouped product is one fused sm90 kernel, where in other dtypes it is a
loop that reads the offsets on the host.
Where the layer's params hold ``expert_rows`` (E,) int64 (a view of the
serving engine's counter, :func:`with_row_counter`), every call adds its
rows per expert there.

``apply_moe`` picks among them as the reference does: the local path
outside a mesh, the stationary one when the config asks for it and the
step holds at most ``moe_stationary_max_tokens`` tokens, else the sharded
one.  The reference's ``shard_map`` bodies become explicit
``torch.distributed`` collectives on the mesh's process groups; every
rank runs the same code on the same replicated activations.

``groups`` splits the T token rows into independent routing groups of
T / groups rows each, with their own capacity and FIFO order: the dense
slot pool's decode round, which the reference runs as one batch-1 decode
per slot under ``jax.vmap``, passes one group per slot.  ``groups=1`` is
the reference's single batch.

Expert weights come in three layouts, told apart by their number of
dimensions and leading size: the reference's (E, d, f) stack, the
hoisted (M, r, d, f_lp) layout of :func:`prepare_tree`, or one rank's
(1, r, d, f_lp) block (``launch.sharding.place_params``), which is also
cut over "data" on the reference's FSDP dim and all-gathered over
"data" at use (the weights-stationary path reads a block cut on d as it
is).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding
from repro_torch.models.layers import dense_init

# collectives issued by the sharded paths (each rank counts its own calls)
collectives = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for name in collectives:
        collectives[name] = 0


def init_moe(generator: torch.Generator, cfg, dtype: torch.dtype,
             device: torch.device) -> dict:
    """Router (d, E) in f32; expert stacks (E, d, f) and (E, f, d), and
    (E, d, f) gates for gated configs, each expert drawn like a dense
    weight and written into a preallocated stack."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts

    def stack(in_dim, out_dim):
        w = torch.empty((E, in_dim, out_dim), dtype=dtype, device=device)
        for e in range(E):
            w[e] = dense_init(generator, in_dim, out_dim, dtype, device)
        return w

    p = {"router": dense_init(generator, d, E, torch.float32, device),
         "we_up": stack(d, f), "we_down": stack(f, d)}
    if cfg.gated_ffn:
        p["we_gate"] = stack(d, f)
        if m.capacity_factor is None:
            # the dropless path's one product of gate and up: [gate | up]
            p["we_gate_up"] = torch.cat([p.pop("we_gate"),
                                         p.pop("we_up")], dim=-1)
    return p


# ---------------------------------------------------------------------------
# routing pieces shared by every path
# ---------------------------------------------------------------------------


def _route(router_w: torch.Tensor, cfg, xf: torch.Tensor,
           groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf (T, d) -> (combine weights (T, E) f32, aux scalar f32).

    Softmax over the experts, top-k, renormalised gates; the aux term is
    the Switch load-balance loss over the top-1 one-hot's density, the
    mean of each group's."""
    probs, gate, idx = _top_k(router_w, cfg, xf)
    w_dense = torch.zeros_like(probs).scatter_(1, idx, gate)
    return w_dense, _aux(cfg, probs, idx, groups)


def _top_k(router_w: torch.Tensor, cfg, xf: torch.Tensor):
    """(probs (T, E), gates (T, K), expert ids (T, K)): the f32 softmax
    over every expert, its top-k and the renormalised gates."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def _aux(cfg, probs: torch.Tensor, idx: torch.Tensor,
         groups: int) -> torch.Tensor:
    """The Switch load-balance term over the top-1 one-hot's density,
    the mean of each group's."""
    m = cfg.moe
    E = m.num_experts
    # the top-1 one-hot, compared in place (no host check of the ids)
    top1 = (idx[:, :1] == torch.arange(E, device=idx.device)).to(
        probs.dtype)
    density = top1.view(groups, -1, E).mean(1)
    proxy = probs.view(groups, -1, E).mean(1)
    return ((density * proxy).sum(-1) * E * m.router_aux_weight).mean()


def _expert_ffn(xb, wu, wd, wg):
    up = xb @ wu
    h = (F.silu(xb @ wg) * up if wg is not None
         else F.gelu(up, approximate="tanh"))
    return h @ wd


def _capacity(cfg, T_loc: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * T_loc * m.top_k / m.num_experts))
    return max(min(c, T_loc), 1)


def _fifo(w_col: torch.Tensor, C: int,
          groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows one expert computes: in each group, its first C assigned
    tokens (a top-k over ``T - arange(T)``, 0 where unassigned).  Returns
    (row indices (groups * C,), valid (groups * C,) bool); a slot the
    group cannot fill holds an unassigned row marked invalid."""
    w = w_col.view(groups, -1)
    Tg = w.shape[1]
    assigned = w > 0
    order = Tg - torch.arange(Tg, device=w.device)
    priority = torch.where(assigned, order, torch.zeros_like(order))
    _, idx = torch.topk(priority, C, dim=-1)
    valid = torch.gather(assigned, 1, idx)
    rows = idx + Tg * torch.arange(groups, device=w.device)[:, None]
    return rows.reshape(-1), valid.reshape(-1)


def _one_expert(xf, w_col, wu, wd, wg, C: int,
                groups: int = 1) -> torch.Tensor:
    """Capacity-bounded FIFO compute of one expert on local tokens.

    xf (T, d); w_col (T,) combine weights; returns (T, d) contribution."""
    rows, valid = _fifo(w_col, C, groups)
    xb = xf[rows] * valid[:, None].to(xf.dtype)
    yb = _expert_ffn(xb, wu, wd, wg)
    yb = yb * (w_col[rows] * valid).to(xf.dtype)[:, None]
    return torch.zeros_like(xf).index_add_(0, rows, yb)


# ---------------------------------------------------------------------------
# single-device path
# ---------------------------------------------------------------------------


def _apply_moe_local(p, cfg, xf, groups: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if p["we_up"].ndim != 3:
        raise ValueError(
            f"expert weights of shape {tuple(p['we_up'].shape)} are laid "
            f"out for a mesh; run them inside its ShardingContext")
    w_dense, aux = _route(p["router"], cfg, xf, groups)
    C = _capacity(cfg, xf.shape[0] // groups)
    out = torch.zeros_like(xf)
    # unbound, the stacks' gradient is one stack each (indexing would
    # make a full-size one per expert)
    wus, wds = p["we_up"].unbind(0), p["we_down"].unbind(0)
    wgs = p["we_gate"].unbind(0) if "we_gate" in p else None
    for e in range(cfg.moe.num_experts):
        out = out + _one_expert(xf, w_dense[:, e], wus[e], wds[e],
                                None if wgs is None else wgs[e], C, groups)
    return out, aux


# ---------------------------------------------------------------------------
# dropless path: grouped products over the rows sorted by expert
# ---------------------------------------------------------------------------


def dropless(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.capacity_factor is None


def _apply_moe_grouped(p, cfg, xf, groups: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every routed row of xf (T, d): the T x K (token, expert)
    assignments sorted by expert (a stable sort, so each expert's rows
    keep token order), the group offsets of the sorted rows, one grouped
    product for [gate | up], SiLU(gate) * up, one for down; then each
    token's K rows put back in token order and summed with their gates as
    weights, in one batched product (deterministic, where an
    ``index_add_`` of the rows would sum in the atomics' order).
    ``groups`` only groups the aux term."""
    if xf.is_cuda and xf.dtype != torch.bfloat16:
        raise ValueError(
            f"{cfg.name}: the dropless MoE runs on the card in bfloat16 "
            f"only (torch's grouped product in {xf.dtype} reads its group "
            f"offsets on the host, so no CUDA graph can hold it)")
    probs, gate, idx = _top_k(p["router"], cfg, xf)
    aux = _aux(cfg, probs, idx, groups)
    T, K = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(cfg.moe.num_experts, dtype=torch.int64,
                         device=xf.device).scatter_add_(
                             0, flat, torch.ones_like(flat))
    if "expert_rows" in p:
        p["expert_rows"].add_(counts)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = xf[order // K]                                   # (T K, d)
    f = cfg.d_ff
    h = torch._grouped_mm(xs, p["we_gate_up"], offs=offs)
    a = F.silu(h[:, :f]) * h[:, f:]
    y = torch._grouped_mm(a, p["we_down"], offs=offs)     # (T K, d)
    y = torch.empty_like(y).index_copy_(0, order, y).view(T, K, -1)
    out = torch.bmm(gate.to(y.dtype).unsqueeze(1), y).squeeze(1)
    return out, aux


def with_row_counter(params: dict, cfg, device: torch.device):
    """(params, counter): for a dropless config, params whose MoE layers
    each hold ``expert_rows``, a view of row i of one (layers, experts)
    int64 counter on ``device`` that every call of the grouped path adds
    its routed rows per expert to; the caller's params are not changed.
    Other configs: (params, None)."""
    if not dropless(cfg):
        return params, None
    layers = [i for i, blk in enumerate(cfg.layer_pattern())
              if blk.ffn == "moe"]
    counter = torch.zeros((len(cfg.layer_pattern()), cfg.moe.num_experts),
                          dtype=torch.int64, device=device)
    new = dict(params, layers=list(params["layers"]))
    for i in layers:
        layer = new["layers"][i]
        new["layers"][i] = dict(layer, ffn=dict(layer["ffn"],
                                                expert_rows=counter[i]))
    return new, counter


# ---------------------------------------------------------------------------
# expert-weight layouts for the "model" axis
# ---------------------------------------------------------------------------


def _layout_dims(cfg, M: int):
    E = cfg.moe.num_experts
    e_par = math.gcd(E, M)
    f_par = M // e_par
    r = E // e_par                      # experts per expert-parallel shard
    f_lp = cfg.d_ff // f_par
    return e_par, f_par, r, f_lp


def layout_cols(w, cfg, M):
    """(..., E, d, f) -> (..., M, r, d, f_lp)."""
    e_par, f_par, r, f_lp = _layout_dims(cfg, M)
    lead = tuple(w.shape[:-3])
    d = w.shape[-2]
    w = w.reshape(*lead, e_par, r, d, f_par, f_lp)
    n = len(lead)
    perm = tuple(range(n)) + tuple(n + i for i in (0, 3, 1, 2, 4))
    return w.permute(perm).reshape(*lead, M, r, d, f_lp)


def layout_rows(w, cfg, M):
    """(..., E, f, d) -> (..., M, r, f_lp, d)."""
    e_par, f_par, r, f_lp = _layout_dims(cfg, M)
    lead = tuple(w.shape[:-3])
    d = w.shape[-1]
    w = w.reshape(*lead, e_par, r, f_par, f_lp, d)
    n = len(lead)
    perm = tuple(range(n)) + tuple(n + i for i in (0, 2, 1, 3, 4))
    return w.permute(perm).reshape(*lead, M, r, f_lp, d)


def layout_cols_inv(w, cfg, M):
    """Inverse of layout_cols (for accumulated gradients)."""
    e_par, f_par, r, f_lp = _layout_dims(cfg, M)
    lead = tuple(w.shape[:-4])
    d = w.shape[-2]
    w = w.reshape(*lead, e_par, f_par, r, d, f_lp)
    n = len(lead)
    perm = tuple(range(n)) + tuple(n + i for i in (0, 2, 3, 1, 4))
    return w.permute(perm).reshape(*lead, cfg.moe.num_experts, d, cfg.d_ff)


def layout_rows_inv(w, cfg, M):
    e_par, f_par, r, f_lp = _layout_dims(cfg, M)
    lead = tuple(w.shape[:-4])
    d = w.shape[-1]
    w = w.reshape(*lead, e_par, f_par, r, f_lp, d)
    n = len(lead)
    perm = tuple(range(n)) + tuple(n + i for i in (0, 2, 1, 3, 4))
    return w.permute(perm).reshape(*lead, cfg.moe.num_experts, cfg.d_ff, d)


def _map_experts(tree, cols, rows):
    if isinstance(tree, dict):
        if "we_up" in tree:
            out = dict(tree)
            out["we_up"] = cols(tree["we_up"])
            if "we_gate" in tree:
                out["we_gate"] = cols(tree["we_gate"])
            out["we_down"] = rows(tree["we_down"])
            return out
        return {k: _map_experts(v, cols, rows) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_experts(v, cols, rows) for v in tree]
    return tree


def prepare_tree(params, cfg, M: int):
    """Hoisted layout: every MoE weight of the params tree in the
    (M, r, d, f_lp) / (M, r, f_lp, d) layout, detected downstream by the
    extra leading M dim.  The input tree is not modified."""
    return _map_experts(params, lambda w: layout_cols(w, cfg, M),
                        lambda w: layout_rows(w, cfg, M))


def unprepare_grads(grads, cfg, M: int):
    """Inverse transform for gradients accumulated in hoisted layout."""
    return _map_experts(grads, lambda w: layout_cols_inv(w, cfg, M),
                        lambda w: layout_rows_inv(w, cfg, M))


def expert_block(w: torch.Tensor, cfg, M: int, j: int,
                 rows: bool) -> torch.Tensor:
    """Rank j's (r, d, f_lp) block (``rows``: (r, f_lp, d)) of the
    hoisted layout, ``layout_cols(w)[j]`` / ``layout_rows(w)[j]``, from
    any of the three layouts.  From an (E, d, f) stack it is a view:
    experts [e * r, e * r + r) and FFN columns [i * f_lp, i * f_lp + f_lp)
    with j = e * f_par + i."""
    if w.ndim == 4:                     # hoisted (M, ...) or a rank's (1, ...)
        return w[j] if w.shape[0] == M else w[0]
    _, f_par, r, f_lp = _layout_dims(cfg, M)
    e, i = divmod(j, f_par)
    w = w[e * r:(e + 1) * r]
    f_cols = slice(i * f_lp, (i + 1) * f_lp)
    return w[:, f_cols, :] if rows else w[:, :, f_cols]


# ---------------------------------------------------------------------------
# collectives over the mesh's axes
# ---------------------------------------------------------------------------


def _dp_axes(ctx) -> Tuple[str, ...]:
    dp = ctx.rules.get("batch")
    return dp if isinstance(dp, tuple) else ((dp,) if dp else ())


# Gradients through the mesh paths.  Every rank runs the same replicated
# forward around the MoE layer and computes the same loss, so a rank's
# gradient of anything outside the layer must be the whole loss's.
# Inside the layer each rank's cotangents are its partial share: the
# collectives (``launch.sharding``) carry their true transposes
# (all_reduce <-> all_reduce, all_gather <-> reduce-scatter),
# ``sharding.leave`` splits the replicated cotangent of the layer's
# results into size equal shares, and ``sharding.enter`` sums the partial
# gradients of a replicated input over the axes it is replicated on.  The
# forward counts in ``collectives`` are unchanged.
#
# Summed over every rank, those partials give the gradient of the mean
# of the data-parallel ranks' objectives: ``leave`` shares each rank's
# cotangent of the layer's result (a result the same on every one of
# them) over the whole mesh.  That is each rank's share for a leaf or an
# input whole over the data axes (``sharding.sum_over_data`` or the rows
# gather's reduce-scatter sums the shares).  A leaf cut over "data"
# carries the sum of its "data" ranks' objectives' gradients instead (an
# FSDP gather's reduce-scatter sums each rank's own), so ``_entered``
# scales a block cut over "data" by D, the "data" size
# (:class:`_DataShares`).


class _DataShares(torch.autograd.Function):
    """Identity; the backward scales the gradient by ``D``."""

    @staticmethod
    def forward(ctx, t, D):
        ctx.D = D
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.D, None


def _all_reduce(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over ``axes``: in place, or out of place when ``t`` carries a
    gradient."""
    collectives["all_reduce"] += len(axes)
    return sharding.all_reduce(t, mesh, axes)


def _all_gather_rows(t: torch.Tensor, mesh,
                     axes: Sequence[str]) -> torch.Tensor:
    """Concatenate every rank's rows over ``axes``, minor axis first, so
    row (i_major * n_minor + i_minor) * T_loc + t lands in order."""
    collectives["all_gather"] += len(tuple(axes))
    return sharding.gather_rows(t, mesh, axes)


def _mean_over_mesh(aux: torch.Tensor, mesh) -> torch.Tensor:
    aux = _all_reduce(aux.reshape(1).clone(), mesh, mesh.axis_names)
    return aux[0] / mesh.size


def _data_cut(w: torch.Tensor, name: str, cfg, mesh) -> Optional[int]:
    """The dim of a rank's own (1, r, ., .) expert block that is this
    rank's slice over "data" (``sharding.expert_data_dim``; a block
    ``place_params`` left whole over "data" has none)."""
    if w.ndim != 4:
        return None
    dim = sharding.expert_data_dim(name, cfg, mesh)
    if dim is None:
        return None
    _, _, r, f_lp = _layout_dims(cfg, mesh.shape["model"])
    d = cfg.d_model
    whole = (1, r, f_lp, d) if name == "we_down" else (1, r, d, f_lp)
    return dim if w.shape[dim] < whole[dim] else None


def _entered(p, xf, mesh, cfg, keep_d: bool = False):
    """The layer's replicated inputs behind ``sharding.enter``: the tokens
    and the router over every axis; an expert stack in the reference's or
    the hoisted layout also over every axis, a rank's own (1, r, ...)
    block over the axes other than "model", and a block cut over "data"
    (D4: the reference's FSDP dim) over those other than "model" and
    "data", its gradient scaled by D, then all-gathered over "data" (its
    backward the reduce-scatter).  With ``keep_d`` a block whose "data" cut is its d
    dim stays cut (the weights-stationary path reads only the rank's d
    slice); the names of those come back as the second value."""
    everywhere = mesh.axis_names
    block_axes = tuple(ax for ax in everywhere if ax != "model")
    rest = tuple(ax for ax in block_axes if ax != "data")
    M = mesh.shape["model"]
    q = dict(p)
    local_d = set()
    q["router"] = sharding.enter(p["router"], mesh, everywhere)
    for name in ("we_up", "we_down", "we_gate"):
        if name not in p:
            continue
        w = p[name]
        cut = _data_cut(w, name, cfg, mesh)
        if cut is not None:
            w = sharding.enter(w, mesh, rest)
            if w.requires_grad and torch.is_grad_enabled():
                w = _DataShares.apply(w, mesh.shape["data"])
            d_dim = 3 if name == "we_down" else 2
            if keep_d and cut == d_dim:
                local_d.add(name)
            else:
                w = sharding.all_gather(w, mesh, "data", cut)
            q[name] = w
            continue
        own = w.ndim == 4 and w.shape[0] != M
        q[name] = sharding.enter(w, mesh, block_axes if own else everywhere)
    return q, sharding.enter(xf, mesh, everywhere), local_d


def _my_rows(xf, mesh, dp_axes, groups: int):
    """This rank's token rows and routing groups (the shard_map
    ``in_specs`` P(dp, None)): one batch splits into one group per rank,
    several groups into whole groups per rank."""
    i, n = sharding.rank_over(mesh, dp_axes)
    T = xf.shape[0]
    if T % n or (groups > 1 and groups % n):
        raise ValueError(f"{T} token rows in {groups} groups do not split "
                         f"over {n} data-parallel ranks")
    T_loc = T // n
    return xf[i * T_loc:(i + 1) * T_loc], max(groups // n, 1)


def _weights(p, cfg, M: int, j: int):
    wg = p.get("we_gate")
    return (expert_block(p["we_up"], cfg, M, j, rows=False),
            expert_block(p["we_down"], cfg, M, j, rows=True),
            None if wg is None else expert_block(wg, cfg, M, j, rows=False))


# ---------------------------------------------------------------------------
# sharded path (expert parallel over 'model', no all-to-all)
# ---------------------------------------------------------------------------


def _apply_moe_sharded(p, cfg, xf, ctx, groups: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    mesh = ctx.mesh
    M = mesh.shape["model"]
    _, f_par, r, _ = _layout_dims(cfg, M)
    j = mesh.local_rank("model")
    p, xf, _ = _entered(p, xf, mesh, cfg)
    wu, wd, wg = _weights(p, cfg, M, j)
    dp_axes = _dp_axes(ctx)
    x_loc, g_loc = _my_rows(xf, mesh, dp_axes, groups)
    w_dense, aux = _route(p["router"], cfg, x_loc, g_loc)
    C = _capacity(cfg, x_loc.shape[0] // g_loc)
    my_e_par = j // f_par
    out = torch.zeros_like(x_loc)
    wu, wd = wu.unbind(0), wd.unbind(0)
    wg = None if wg is None else wg.unbind(0)
    for q in range(r):
        # rank j owns experts [my_e_par * r, my_e_par * r + r)
        e = my_e_par * r + q
        out = out + _one_expert(x_loc, w_dense[:, e], wu[q], wd[q],
                                None if wg is None else wg[q], C, g_loc)
    out = _all_reduce(out, mesh, ("model",))
    # aux varies across token shards: mean it over every rank
    aux = _mean_over_mesh(aux, mesh)
    out = _all_gather_rows(out, mesh, dp_axes)
    return sharding.leave(out, mesh), sharding.leave(aux, mesh)


def _apply_moe_stationary(p, cfg, xf, ctx, groups: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights-stationary serving path (decode-sized token counts).

    Expert weights stay where they are (expert-major on 'model'; each
    'data' rank reads only its d_lp-wide slice of the contraction dim),
    and the tiny token batch moves instead: all-gathered over the data
    axes, partial pre-activations summed over 'data', outputs over
    'data' and 'model'.  After that sum every rank holds every row, so
    the rows come back replicated without the reference's slice back to
    the token shard."""
    mesh = ctx.mesh
    M = mesh.shape["model"]
    D = mesh.shape["data"]
    _, f_par, r, _ = _layout_dims(cfg, M)
    d_model = xf.shape[-1]
    if d_model % D:
        raise ValueError(f"d_model {d_model} does not split over {D} "
                         f"'data' ranks")
    d_lp = d_model // D
    j = mesh.local_rank("model")
    di = mesh.local_rank("data") * d_lp
    cut = slice(di, di + d_lp)
    p, xf, local_d = _entered(p, xf, mesh, cfg, keep_d=True)
    wu, wd, wg = _weights(p, cfg, M, j)
    dp_axes = _dp_axes(ctx)
    x_loc, _ = _my_rows(xf, mesh, dp_axes, groups)
    x_all = _all_gather_rows(x_loc, mesh, dp_axes)
    T = x_all.shape[0]
    w_dense, aux = _route(p["router"], cfg, x_all, groups)
    C = _capacity(cfg, T // groups)
    x_slice = x_all[:, cut]
    my_e_par = j // f_par
    out_full = torch.zeros((T, d_model), dtype=torch.float32,
                           device=xf.device)
    wu, wd = wu.unbind(0), wd.unbind(0)
    wg = None if wg is None else wg.unbind(0)
    def mine(w, name, rows=False):
        """Expert q's slice of the local d dim (the block itself where
        ``place_params`` cut it there over "data")."""
        if name in local_d:
            return w
        return w[:, cut] if rows else w[cut]

    for q in range(r):
        e = my_e_par * r + q
        w_col = w_dense[:, e]
        rows, valid = _fifo(w_col, C, groups)
        xb = x_slice[rows] * valid[:, None].to(x_slice.dtype)
        # partial pre-activations over the local d-slice, summed over data
        up = _all_reduce(xb @ mine(wu[q], "we_up"), mesh, ("data",))
        if wg is not None:
            g = _all_reduce(xb @ mine(wg[q], "we_gate"), mesh, ("data",))
            h = F.silu(g) * up
        else:
            h = F.gelu(up, approximate="tanh")
        yb = h @ mine(wd[q], "we_down", rows=True)   # (C, d_lp)
        yb = yb * (w_col[rows] * valid).to(yb.dtype)[:, None]
        out_full[:, cut].index_add_(0, rows, yb.float())
    # disjoint d-slices sum over 'data'; disjoint experts over 'model'
    out_full = _all_reduce(out_full, mesh, ("data", "model"))
    aux = _mean_over_mesh(aux, mesh)
    return (sharding.leave(out_full.to(xf.dtype), mesh),
            sharding.leave(aux, mesh))


def apply_moe(p: dict, cfg, x: torch.Tensor, groups: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux scalar).

    A dropless config takes the grouped path (outside a mesh only).
    Inside a ShardingContext whose mesh has a "model" axis, the
    stationary path serves when ``cfg.moe_stationary_serve`` is set, the
    mesh has a "data" axis and a routing group holds at most
    ``moe_stationary_max_tokens`` tokens; otherwise the sharded path.
    Outside one, the local path.

    When the context's step splits the rows over ``batch_axes`` (the
    train step's batch, a dense pool's slots), ``x`` holds this rank's
    rows: they are all-gathered first (its backward a reduce-scatter) and
    ``groups`` counts the groups of the gathered batch, so routing,
    groups and capacities are the whole batch's, as without the split;
    the output keeps this rank's rows."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    ctx: Optional[sharding.ShardingContext] = sharding.current()
    if dropless(cfg):
        if ctx is not None:
            raise ValueError(f"{cfg.name}: the dropless MoE runs outside a "
                             "mesh only")
        out, aux = _apply_moe_grouped(p, cfg, xf, groups)
        return out.reshape(B, S, d), aux
    if ctx is None or "model" not in ctx.mesh.axis_names:
        out, aux = _apply_moe_local(p, cfg, xf, groups)
        return out.reshape(B, S, d), aux
    rows = ctx.batch_axes
    if rows:
        # the step's rows are split over ``rows``: every path below routes
        # the whole batch, so gather it, and keep this rank's rows after
        xf = _all_gather_rows(xf, ctx.mesh, rows)
    if (cfg.moe_stationary_serve and "data" in ctx.mesh.axis_names
            and xf.shape[0] // groups <= cfg.moe_stationary_max_tokens):
        out, aux = _apply_moe_stationary(p, cfg, xf, ctx, groups)
    else:
        out, aux = _apply_moe_sharded(p, cfg, xf, ctx, groups)
    if rows:
        out = sharding.my_rows(out, ctx.mesh, rows)
    return out.reshape(B, S, d), aux
