"""Step builders: the train and eval steps, and serving's dense prefill /
decode and paged steps.

Port of ``repro/train/steps.py``.  The train step is
:func:`make_grad_step`'s gradients (microbatched, accumulated in f32)
followed by one AdamW update; the serving steps run the forward under
``torch.no_grad()``.  Inside a mesh's ``ShardingContext`` the steps take
the rank's placed params (``launch.sharding.place_params``) and the
train step is data-parallel (:func:`make_grad_step`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.optim import tree_leaves, tree_map
from repro_torch.launch import sharding
from repro_torch.models import moe
from repro_torch.models.transformer import forward
from repro_torch.roofline.hooks import trips
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.losses import chunked_ce_loss


def microbatches(cfg, batch: int) -> int:
    """The reference's microbatch count k for a global batch: at most
    ``cfg.microbatches`` and ``batch``, dividing ``batch``, and inside a
    mesh's context also leaving ``batch / k`` divisible by the
    data-parallel ranks ("pod" x "data")."""
    k = max(1, min(cfg.microbatches, batch))
    while batch % k:
        k -= 1
    ctx = sharding.current()
    if ctx is not None:
        dp = math.prod(ctx.mesh.shape[ax] for ax in ("pod", "data")
                       if ax in ctx.mesh.axis_names)
        while k > 1 and ((batch // k) % dp or batch % k):
            k -= 1
    return k


def _hoist_ranks(cfg, params) -> int:
    """The "model" ranks to hoist the MoE expert layout over (0: none):
    a MoE config with ``hoist_moe_layout`` inside a mesh with "model",
    whose experts are whole (E, d, f) stacks (placed ones already are
    their rank's block of that layout)."""
    ctx = sharding.current()
    if (cfg.moe is not None and cfg.hoist_moe_layout and ctx is not None
            and "model" in ctx.mesh.axis_names):
        ups = [layer["ffn"]["we_up"] for layer in params["layers"]
               if "we_up" in layer.get("ffn", {})]
        if any(w.dim() == 4 for w in ups):
            return 0
        return ctx.mesh.shape["model"]
    return 0


def _row_split(mesh, rows: int):
    """(axes the rows of a microbatch split over, their size, the size of
    the data axes left whole): ``launch.specs._batch_axes``, which keeps
    a batch no data axis divides whole."""
    from repro_torch.launch.specs import _batch_axes
    axes = _batch_axes(mesh, rows)
    axes = () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))
    n_split = sharding.axes_size(mesh, axes)
    n_dp = sharding.axes_size(mesh, sharding.data_axes(mesh))
    return axes, n_split, n_dp // n_split


def _loss(params, cfg, batch, split=(), n_split=1, n_rest=1):
    """(the objective this rank differentiates, CE loss, aux), the last
    two the whole batch's.  On a mesh each data rank's objective is its
    share, so that the shares sum to the loss over the data ranks: its
    rows' CE weighted by their part of the batch's positions plus 1 /
    n_split of the aux term (the MoE layers route the gathered batch, so
    ``aux`` is the batch's on every rank), all over the ``n_rest`` data
    ranks that hold the same rows."""
    out = forward(params, cfg, batch, mode="train")
    loss = chunked_ce_loss(params, cfg, out["hidden"], batch["labels"],
                           batch.get("mask"))
    aux = out["aux"]
    ctx = sharding.current()
    if ctx is None:
        return loss + aux, loss, aux
    mesh = ctx.mesh
    with torch.no_grad():
        B, S = out["hidden"].shape[:2]
        cnt = (batch["mask"].float().sum() if batch.get("mask") is not None
               else torch.tensor(float(B * S), device=loss.device))
        total = cnt.reshape(1).clone()
        sharding.all_reduce(total, mesh, split)
        share = cnt / torch.clamp(total[0], min=1.0)
        whole = (loss.detach() * share).reshape(1).clone()
        sharding.all_reduce(whole, mesh, split)
    objective = (loss * share + aux / n_split) / n_rest
    return objective, whole[0], aux.detach()


def make_grad_step(cfg):
    """``grad_step(params, batch) -> (grads, metrics)``: the gradient of
    the CE loss plus the MoE ``aux`` term, shaped like ``params``.

    The batch (every entry with the batch axis first) splits into
    :func:`microbatches` k row blocks; each block's gradient is taken
    (``torch.autograd.grad``) and accumulated in f32, then divided by k.
    With k = 1 the gradients keep the params' dtype, as in the reference.
    Inside a mesh with a "model" axis a MoE config with
    ``hoist_moe_layout`` and whole expert stacks differentiates with
    respect to ``moe.prepare_tree(params)`` (the expert layout made once
    a step) and maps the gradients back with ``moe.unprepare_grads``.

    On a mesh the step is data-parallel.  ``params`` are this rank's
    placed blocks and ``batch`` the whole batch, on every rank; each
    microbatch's rows split over the data axes (``launch.specs.
    _batch_axes``: a microbatch no data axis divides stays whole), each
    rank running its own rows, and the grads returned are this rank's
    blocks of the whole loss's.  Each rank differentiates its share of
    the loss (:func:`_loss`); an FSDP leaf's gradient is summed by its
    gather's reduce-scatter, a tensor-parallel block's is its own, and
    every leaf held whole over a data axis is summed over it here
    (``sharding.sum_over_data``).  Metrics: ``loss``, ``aux_loss``,
    ``total_loss`` (f32 scalars, the whole batch's, the mean over the
    microbatches)."""
    def grad_step(params, batch):
        ctx = sharding.current()
        B = batch["tokens"].shape[0]
        k = microbatches(cfg, B)
        M = _hoist_ranks(cfg, params)
        gparams = moe.prepare_tree(params, cfg, M) if M else params
        wrt = tree_map(lambda t: t.detach().requires_grad_(), gparams)
        leaves = tree_leaves(wrt)
        rows = B // k
        split, n_split, n_rest = ((), 1, 1) if ctx is None else \
            _row_split(ctx.mesh, rows)
        inner = ctx.split_rows(split) if ctx is not None else None
        acc = None
        sums = torch.zeros(3, dtype=torch.float32,
                           device=leaves[0].device)
        for i in trips(k, backward_inside=True):
            mb = {name: v[i * rows:(i + 1) * rows]
                  for name, v in batch.items()}
            if split:
                mb = {name: sharding.my_rows(v, ctx.mesh, split)
                      for name, v in mb.items()}
            with sharding.use(inner):
                obj, loss, aux = _loss(wrt, cfg, mb, split, n_split,
                                       n_rest)
                grads = torch.autograd.grad(obj, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            sums += torch.stack([loss + aux, loss, aux]).detach().float()
            if k == 1:
                acc = grads
            elif acc is None:
                acc = [g.float() for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            del obj, loss, aux, grads
        if k > 1:
            acc = [a / k for a in acc]
            sums = sums / k
        it = iter(acc)
        grads = tree_map(lambda _: next(it), gparams)
        if M:
            grads = moe.unprepare_grads(grads, cfg, M)
        if ctx is not None:
            grads = sharding.sum_over_data(grads, cfg, ctx.mesh)
        return grads, {"total_loss": sums[0], "loss": sums[1],
                       "aux_loss": sums[2]}

    return grad_step


def make_train_step(cfg, opt_cfg: Optional[opt_lib.AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`make_grad_step`'s gradients, then one AdamW update
    (weight decay where the reference's layout has two or more dims,
    ``optimizer.decay_mask``).  Metrics: ``loss``, ``aux_loss``,
    ``total_loss``, ``lr`` and ``grad_norm``.  On a mesh AdamW updates
    this rank's blocks, with the gradient norm summed over exactly the
    axes each leaf is cut on."""
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    grad_step = make_grad_step(cfg)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_step(params, batch)
        ctx = sharding.current()
        mesh = ctx.mesh if ctx is not None else None
        params, opt_state, m = opt_lib.update(
            opt_cfg, grads, opt_state, params,
            decay=opt_lib.decay_mask(params, cfg),
            shards=None if mesh is None else sharding.split_axes(cfg, mesh),
            mesh=mesh)
        metrics.update(m)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    """Forward-only loss (validation), under ``torch.no_grad()``."""
    def eval_step(params, batch):
        with torch.no_grad():
            out = forward(params, cfg, batch, mode="train")
            return chunked_ce_loss(params, cfg, out["hidden"],
                                   batch["labels"], batch.get("mask"))

    return eval_step


def pick_tokens(logits: torch.Tensor, sample: bool, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or a draw with ``torch.multinomial`` from
    ``generator`` (the engine's), over the last axis: (B, V) -> (B,) or,
    for codebooks, (B, K, V) -> (B, K), int32."""
    if sample:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                generator=generator)
        tok = tok.reshape(logits.shape[:-1])
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)


def make_prefill_step(cfg, max_len: Optional[int] = None):
    """Prompt prefill into fresh dense states.

    batch = {tokens (B, S)[, patches (B, P, vision_dim)]}; returns
    (last_logits (B, V), states whose caches are ``max_len`` deep)."""
    def prefill_step(params, batch):
        out = forward(params, cfg, batch, mode="prefill", max_len=max_len)
        return out["last_logits"], out["states"]

    return prefill_step


def make_decode_step(cfg, sample: bool = False, temperature: float = 1.0):
    """One decode token per row of dense states, each row at its own
    position; the K/V caches are written in place.

    batch = {tokens (B, 1)}; returns (logits (B, V), tokens (B,) int32,
    new states)."""
    def decode_step(params, batch, states,
                    generator: Optional[torch.Generator] = None):
        out = forward(params, cfg, batch, mode="decode", states=states)
        logits = out["logits"]
        return (logits, pick_tokens(logits, sample, temperature, generator),
                out["states"])

    return decode_step


def make_paged_prefill_step(cfg, num_pages: Optional[int] = None):
    """One prompt chunk into the shared page pool (batch 1).

    batch = {tokens (1, C), start int, block_table (W,)}; returns
    (chunk_logits (1, C, V), page pools written in place).  ``num_pages``
    (the whole pool's size) places the pool on a mesh."""
    def paged_prefill_step(params, batch, states):
        out = forward(params, cfg, dict(batch, num_pages=num_pages),
                      mode="paged_prefill", states=states)
        return out["chunk_logits"], out["states"]

    return paged_prefill_step


def make_paged_decode_step(cfg, sample: bool = False,
                           temperature: float = 1.0,
                           num_pages: Optional[int] = None):
    """One decode token per lane over the shared page pool.

    batch = {tokens (B, 1), block_tables (B, W) int32, lengths (B,) int32};
    inactive lanes carry all-null tables and length 0.  Greedy decoding
    takes the argmax; sampled decoding draws with ``torch.multinomial``
    from ``generator`` (the engine's).  ``num_pages`` (the whole pool's
    size) places the pool on a mesh."""
    def paged_decode_step(params, batch, states,
                          generator: Optional[torch.Generator] = None):
        out = forward(params, cfg, dict(batch, num_pages=num_pages),
                      mode="paged_decode", states=states)
        logits = out["logits"]
        return (logits, pick_tokens(logits, sample, temperature, generator),
                out["states"])

    return paged_decode_step
