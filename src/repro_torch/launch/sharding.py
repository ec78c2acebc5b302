"""Logical-axis sharding rules, the placement of weights and layer states
on a mesh, and the collectives the placed layers issue.

Port of ``repro/launch/sharding.py``.  A :class:`ShardingContext` maps the
models' logical axis names ("batch", "heads", "ff", ...) to mesh axes, as
the reference's does, and :func:`use` makes one current for the steps run
inside it.

The rule functions (:func:`param_pspecs`, :func:`state_pspecs`) give, leaf
for leaf, the reference's ``PartitionSpec`` as a tuple of mesh-axis names
(``None`` for a replicated dim).  The port places by them:

* :func:`place_params` hands each rank its block of every weight: matrices
  tensor-parallel on "model" and FSDP on "data", the embedding
  vocab-parallel; the MoE expert stacks become the rank's block of the
  hoisted expert layout of ``moe.expert_block``, cut over "data" on the
  reference's FSDP dim as well (:func:`expert_data_dim`).
  :func:`unplace_params` gathers a placed tree back whole.
* :func:`place_states` cuts a dense slot pool: slots over "data", the K/V
  rings' sequence dim and the mLSTM ``C`` / ``n`` rows over "model";
  the other recurrent states take the slot cut only.
* :func:`page_block` names this rank's block of a paged pool: its pages
  over the data axes, nothing over "model".

The layers read their weights through :func:`weight`, which all-gathers
every axis a layer does not compute on in place (FSDP's "data" always;
"model" where the layer's compute cannot use the shard, such as a
projection cut mid-head, the mLSTM's projections or the sLSTM's
weights).  Every collective
goes through the autograd Functions below, each with its transpose, and
each call is counted in :data:`collectives`.  Activations are placed
explicitly by the layers and the step builders, so :func:`act` is the
identity.  Each context records the layout its layers used
(:func:`placement_report`).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_state = threading.local()

# default logical-axis -> mesh-axis rules (single-pod mesh ('data','model'))
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": "data",        # replaced by ('pod','data') on the multi-pod mesh
    "seq": None,            # sequence usually replicated...
    "kv_seq": "model",      # ...but decode KV caches shard sequence on model
    "heads": "model",
    "kv_heads": None,       # kv heads can be tiny (MQA kv=1): replicate
    "ff": "model",
    "expert": "model",
    "vocab": "model",
    "embed": None,
    "hidden": None,
    "rec": "model",         # recurrent width (RG-LRU / xLSTM projections)
}

Spec = Tuple[Optional[object], ...]

# collectives issued by the placed layers and the MoE paths (each rank
# counts its own calls)
collectives = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for name in collectives:
        collectives[name] = 0


class ShardingContext:
    """A mesh and its rules.  ``batch_axes`` names the mesh axes the
    activations' leading (batch) dim is split over inside a step (none:
    every rank holds every row); ``report`` collects the layout each
    layer used, by the tag :func:`locate` set."""

    def __init__(self, mesh, rules: Optional[Dict[str, object]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        # on a multi-pod mesh, "batch" spans both pod and data axes
        if "pod" in mesh.axis_names and self.rules.get("batch") == "data":
            self.rules["batch"] = ("pod", "data")
        self.batch_axes: Tuple[str, ...] = ()
        self.report: Dict[str, Dict[str, str]] = {}
        self.where = ""

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)

    def split_rows(self, axes: Sequence[str]) -> "ShardingContext":
        """This context with the batch split over ``axes``; the report is
        shared."""
        ctx = copy.copy(self)
        ctx.batch_axes = tuple(axes)
        return ctx


def current() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[ShardingContext]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def act(x, *logical: Optional[str]):
    """The reference's activation-sharding constraint.  The port's layers
    and step builders place activations themselves (the row split of a
    step, the gathers of :func:`weight`), so this returns ``x``
    unchanged, inside a context or not."""
    return x


def locate(tag: str) -> None:
    """Name the part of the model the next :func:`weight` calls belong to
    (``embed``, ``layers.<i>``, ``head``) in the current context's
    report."""
    ctx = current()
    if ctx is not None:
        ctx.where = tag


def note(leaf: str, layout: str) -> None:
    """Record ``layout`` for ``leaf`` at the current tag."""
    ctx = current()
    if ctx is not None:
        ctx.report.setdefault(ctx.where, {})[leaf] = layout


def placement_report(ctx: Optional[ShardingContext] = None) -> dict:
    """What the layers run in ``ctx`` (the current one by default) did
    with each weight and ring: per tag, leaf -> "axis=how ..." with how
    one of ``tp`` (computed on the shard), ``vocab`` (vocab-parallel
    lookup), ``gathered`` (all-gathered before use) or ``split`` (a ring
    cut along its sequence, ``kv_ring``; a page pool cut into page blocks,
    ``kv_pages``); ``whole`` where no axis cuts it."""
    ctx = ctx or current()
    return {} if ctx is None else {k: dict(v) for k, v in ctx.report.items()}


# ---------------------------------------------------------------------------
# parameter sharding rules (by leaf name)
# ---------------------------------------------------------------------------

_COL_SHARDED = {  # shard output dim (last)
    "wq", "wk", "wv", "w_up", "w_gate", "w_in", "w_z", "head",
    "w_gate_in", "w_proj",
}
_ROW_SHARDED = {  # shard input dim (first of the matmul = -2)
    "wo", "w_down", "w_out",
}
_EXPERT_SHARDED = {  # MoE stacked expert weights: shard expert dim (dim 0)
    "we_up", "we_gate", "we_down",
}
_VOCAB_SHARDED = {"embed"}  # (V, d) or (K, V, d): shard the V dim


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
    """2D weight sharding: tensor-parallel on 'model' plus FSDP on 'data',
    divisibility-guarded against the mesh axis sizes (an axis that does
    not divide a dim leaves it replicated; Mixtral's 8 experts on a
    16-way 'model' axis fall back to sharding d_ff).  A path holding
    "scan" has a stacked layer axis in front, skipped."""
    name = path[-1]
    stacked = "scan" in path
    off = 1 if stacked else 0
    spec = [None] * len(shape)

    def put(dim: int, axis: str) -> bool:
        if spec[dim % len(shape)] is not None:
            return False
        if axis_sizes is not None:
            size = axis_sizes.get(axis, 1)
            if size > 1 and shape[dim % len(shape)] % size != 0:
                return False
        spec[dim % len(shape)] = axis
        return True

    if name in _COL_SHARDED and len(shape) - off >= 2:
        put(-1, "model")
        put(-2, "data")
    elif name in _ROW_SHARDED and len(shape) - off >= 2:
        put(-2, "model")
        put(-1, "data")
    elif name in _EXPERT_SHARDED:
        # prefer expert-parallel; fall back to d_ff tensor parallel
        if not put(off, "model"):
            put(-1 if name in ("we_up", "we_gate") else -2, "model")
        # FSDP dim: d for we_up/we_gate; whichever of (f, d) is free for
        # we_down
        if not put(off + 1, "data"):
            put(-1, "data")
    elif name in _VOCAB_SHARDED:
        # (V, d) or (K, V, d) for multi-codebook embeds: V is always dim -2
        put(-2, "model")
        put(-1, "data")
    # biases, norm scales, routers, lru params: replicated
    return tuple(spec)


def _walk(tree, fn, path: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; list
    indices join the path as strings, as the reference's key paths do."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip(tree, other, fn, path: Tuple[str, ...] = ()):
    """``tree`` (dicts and lists of tensors) with each leaf replaced by
    ``fn(path, leaf, other's leaf at the same path)``; ``other``'s leaves
    may be tuples."""
    if isinstance(tree, dict):
        return {k: _zip(v, other[k], fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(v, other[i], fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, other)


def param_pspecs(params, mesh=None):
    """Spec tree matching ``params`` (path-based rules): a tuple of mesh
    axis names per leaf."""
    sizes = dict(mesh.shape) if mesh is not None else None
    return _walk(params, lambda path, leaf: _leaf_spec(
        path, tuple(leaf.shape), sizes))


# ---------------------------------------------------------------------------
# layer-state (KV cache / recurrent state) sharding rules
# ---------------------------------------------------------------------------


def _state_leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                     batch_axes,
                     axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
    name = path[-1]
    stacked = "scan" in path
    off = 1 if stacked else 0
    nd = len(shape) - off
    spec = [None] * len(shape)
    if name == "pos" or nd == 0:
        return tuple(spec)

    def put(dim: int, axes) -> None:
        # a dim the mesh axis does not divide stays replicated (e.g. a
        # 6-lane dense pool on 4-way 'data')
        if axis_sizes is not None:
            size = 1
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                size *= axis_sizes.get(a, 1)
            if size > 1 and shape[dim] % size != 0:
                return
        spec[dim] = axes

    put(off, batch_axes)  # leading real dim is always batch
    if name in ("k", "v", "k_scale", "v_scale") and nd == 4:
        put(off + 2, "model")         # KV cache: shard the sequence dim
    elif name == "C" and nd == 4:
        put(off + 2, "model")         # mLSTM matrix memory: shard head_dim
    elif name == "n" and nd == 3:
        put(off + 2, "model")
    # (B, d)-shaped scalars (slstm c/n/h/m, rglru h) and conv buffers:
    # batch-sharded only.
    return tuple(spec)


def state_pspecs(states, mesh=None, batch_axes="__auto__"):
    """Spec tree matching ``states`` (the port's per-layer list of state
    dicts, or any tree of tensors)."""
    if batch_axes == "__auto__":
        batch_axes = _dp_axes_of(mesh)
    sizes = dict(mesh.shape) if mesh is not None else None
    return _walk(states, lambda path, leaf: _state_leaf_spec(
        path, tuple(leaf.shape), batch_axes, sizes))


def _dp_axes_of(mesh):
    return ("pod", "data") if (mesh is not None and
                               "pod" in mesh.axis_names) else "data"


_RINGS = ("k", "v", "k_scale", "v_scale")


def pool_pspecs(states, mesh):
    """The specs :func:`place_states` cuts a dense slot pool by: the
    reference engine's (``state_pspecs``: slots over the data axes, a K/V
    ring's sequence and the mLSTM ``C`` / ``n`` rows over "model"), with
    one difference: ``pos`` (the port's per-slot position, where the
    reference's pool carries a leading slot dim on every leaf) takes the
    slot cut."""
    specs = state_pspecs(states, mesh)
    dp = _dp_axes_of(mesh)
    sizes = dict(mesh.shape)
    n_dp = math.prod(sizes.get(a, 1) for a in
                     (dp if isinstance(dp, tuple) else (dp,)))

    def fix(path, leaf, spec):
        name = path[-1]
        if name == "pos" and leaf.dim() == 1:
            return (dp,) if leaf.shape[0] % n_dp == 0 else (None,)
        return spec

    return _zip(states, specs, fix)


def page_block(mesh, num_pages: int) -> Optional[Tuple[int, int]]:
    """(first page, pages) of this rank's block of a paged pool of
    ``num_pages`` pages on ``mesh``, as :func:`state_pspecs` cuts the
    ``k_pages`` / ``v_pages`` leaves (their leading dim over the data
    axes, "pod" x "data", nothing over "model"): block i of the data
    ranks holds pages [i P / D, (i + 1) P / D).  None where the pool stays
    whole on every rank (the divisibility guard: D does not divide P, or
    the mesh has no data axis).  A one-rank data axis cuts it into one
    block, the whole pool."""
    dp = data_axes(mesh)
    if not dp or num_pages % axes_size(mesh, dp):
        return None
    i, n = rank_over(mesh, dp)
    return i * (num_pages // n), num_pages // n


# ---------------------------------------------------------------------------
# mesh coordinates
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def rank_over(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """This rank's index over ``axes`` (major first) and their size."""
    rank, size = 0, 1
    for ax in axes:
        rank = rank * mesh.shape[ax] + mesh.local_rank(ax)
        size *= mesh.shape[ax]
    return rank, size


def model_size() -> int:
    """The "model" axis's size in the current context (1 outside one)."""
    ctx = current()
    if ctx is None:
        return 1
    return ctx.mesh.shape.get("model", 1)


def batch_ranks() -> int:
    """How many ways the current step splits the activations' rows."""
    ctx = current()
    if ctx is None:
        return 1
    return rank_over(ctx.mesh, ctx.batch_axes)[1]


def batch_axes_for(mesh, rows: int) -> Tuple[str, ...]:
    """The data axes a slot pool of ``rows`` slots splits over: all of
    them ("pod" and "data") when their product divides ``rows``, else
    none, as :func:`state_pspecs` decides."""
    dp = data_axes(mesh)
    return dp if rows % axes_size(mesh, dp) == 0 else ()


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` of ``mesh``."""
    return math.prod(mesh.shape[a] for a in axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes ("pod", "data"), major first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# collectives with their transposes
# ---------------------------------------------------------------------------
#
# Gradient convention.  A tensor every rank of a group holds alike carries
# its whole gradient on each of them; a rank's shard carries the gradient
# of its block.  Across "data" each rank differentiates its own share of
# the loss (the step builders scale it so the shares sum to the loss), so
# a weight used on several data ranks' rows sums its gradient over them:
# the "data" gather's backward is a reduce-scatter, and the train step
# sums the gradients of weights held whole over "data".  Inside a
# tensor-parallel block (between :func:`enter` and :func:`reduce`) a
# rank's cotangents are its partial share: gathers there sum too
# (``sum_grads``); a "model" gather feeding a computation every rank runs
# alike takes only this rank's slice of the gradient.  The MoE paths use
# :func:`enter` / :func:`leave` / :func:`all_reduce` with the same
# transposes (``models/moe.py``).


def _tracks(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _summed(g: torch.Tensor, groups) -> torch.Tensor:
    g = g.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(g, group=group)
    return g


class _Enter(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``groups``."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.groups), None


class _Exit(torch.autograd.Function):
    """Identity on a replicated result; the backward gives each of the
    ``size`` ranks its share of the cotangent."""

    @staticmethod
    def forward(ctx, t, size):
        ctx.size = size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _AllReduce(torch.autograd.Function):
    """Sum over ``groups``; the backward sums too (partial cotangents)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _summed(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.groups), None


class _Reduce(torch.autograd.Function):
    """Sum of a row-parallel product's partials over ``groups``; the
    replicated result's gradient passes back unchanged."""

    @staticmethod
    def forward(ctx, t, groups):
        return _summed(t, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """Every rank's block of ``group`` along ``dim``, in rank order.  The
    backward is the reduce-scatter (an all-reduce, then this rank's
    block: gloo has no reduce-scatter) when ``summed``, else this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, t, group, n, index, dim, summed):
        ctx.group, ctx.index, ctx.dim, ctx.summed = group, index, dim, summed
        return _gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _summed(g, (ctx.group,))
        size = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return (g.narrow(ctx.dim, ctx.index * size, size),
                None, None, None, None, None)


def _gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts[0] if n == 1 else torch.cat(parts, dim)


def _groups(mesh, axes: Sequence[str]):
    return tuple(mesh.get_group(ax) for ax in axes)


def enter(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Identity into a computation whose ranks' gradients of ``t`` are
    partial: the backward sums them over ``axes``."""
    if not _tracks(t):
        return t
    return _Enter.apply(t, _groups(mesh, axes))


def leave(t: torch.Tensor, mesh) -> torch.Tensor:
    """Identity out of a computation of partial cotangents: the backward
    gives each of the mesh's ranks an equal share."""
    return _Exit.apply(t, mesh.size) if _tracks(t) else t


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over ``axes`` with a summing backward: in place (a strided
    ``t`` too), or out of place when ``t`` carries a gradient."""
    if _tracks(t):
        t = _AllReduce.apply(t, _groups(mesh, axes))
    else:
        # a collective reads and writes dense memory: a strided view (a
        # gradient autograd hands back as a slice of a concatenation's)
        # is reduced in a contiguous copy and written back
        buf = t if t.is_contiguous() else t.contiguous()
        for ax in axes:
            dist.all_reduce(buf, group=mesh.get_group(ax))
        if buf is not t:
            t.copy_(buf)
    collectives["all_reduce"] += len(axes)
    return t


def reduce(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum a row-parallel product's partials over ``axes`` (the
    gradient passes back unchanged)."""
    t = (_Reduce.apply(t, _groups(mesh, axes)) if _tracks(t)
         else _summed(t, _groups(mesh, axes)))
    collectives["all_reduce"] += len(axes)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0,
               sum_grads: bool = True) -> torch.Tensor:
    """Concatenate every rank's ``t`` over ``axis`` along ``dim``; the
    backward reduce-scatters (``sum_grads``) or slices."""
    group, n = mesh.get_group(axis), mesh.shape[axis]
    dim = dim % t.dim()
    if _tracks(t):
        t = _AllGather.apply(t, group, n, mesh.local_rank(axis), dim,
                             sum_grads)
    else:
        t = _gather(t, group, n, dim)
    collectives["all_gather"] += 1
    return t


def gather_rows(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Every rank's rows over ``axes``, minor axis first, so row
    (i_major * n_minor + i_minor) * T_loc + t lands in order."""
    for ax in reversed(tuple(axes)):
        t = all_gather(t, mesh, ax, 0)
    return t


def my_rows(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """This rank's block of ``t``'s rows over ``axes``."""
    i, n = rank_over(mesh, axes)
    rows = t.shape[0] // n
    return t[i * rows:(i + 1) * rows]


# ---------------------------------------------------------------------------
# the layers' view of their weights
# ---------------------------------------------------------------------------


def spec_of(name: str, shape: Sequence[int], mesh=None) -> Spec:
    """The spec of a leaf named ``name`` of global ``shape`` on ``mesh``
    (the current context's by default)."""
    if mesh is None:
        ctx = current()
        mesh = ctx.mesh if ctx is not None else None
    sizes = dict(mesh.shape) if mesh is not None else None
    return _leaf_spec((name,), tuple(shape), sizes)


def _block(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(s // axes_size(mesh, _axes(a))
                 for s, a in zip(shape, spec))


def splits(name: str, shape: Sequence[int], axis: str = "model") -> bool:
    """Whether the current context cuts leaf ``name`` of global ``shape``
    on ``axis`` (False outside a context)."""
    ctx = current()
    return ctx is not None and axis in spec_of(name, shape, ctx.mesh)


def weight(w: torch.Tensor, name: str, shape: Sequence[int], *,
           keep: Sequence[str] = (), partial: bool = False,
           role: str = "tp") -> torch.Tensor:
    """The tensor a layer computes with from its held weight ``w``, a
    leaf named ``name`` of global ``shape``.  Outside a context, ``w``.
    Inside one, ``w`` must be this rank's block of its spec (else this
    raises: place the params first), and every axis that cuts it except
    those in ``keep`` is all-gathered along its dim: "data" (FSDP) with a
    reduce-scatter backward, "model" with one when ``partial`` (a
    tensor-parallel block's partial cotangents) and with a slice
    otherwise.  The layout is recorded in the context's report (``role``
    names how a kept axis is used)."""
    ctx = current()
    if ctx is None:
        return w
    mesh = ctx.mesh
    spec = spec_of(name, shape, mesh)
    want = _block(shape, spec, mesh)
    if tuple(w.shape) != want:
        raise ValueError(
            f"{name}: this rank holds {tuple(w.shape)}, but its block of "
            f"{tuple(shape)} under {spec} is {want}; place the params on "
            f"the mesh first (sharding.place_params)")
    how = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if ax in keep:
            how.append(f"{ax}={role}")
            continue
        w = all_gather(w, mesh, ax, dim, sum_grads=ax != "model" or partial)
        how.append(f"{ax}=gathered")
    note(name, " ".join(how) or "whole")
    return w


def whole(p: dict, shapes: Dict[str, Sequence[int]]) -> dict:
    """``p`` with each leaf named in ``shapes`` (name -> global shape)
    whole on every rank (:func:`weight` with nothing kept): for a block
    that computes whole on every "model" rank.  Outside a context,
    ``p``."""
    if current() is None:
        return p
    q = dict(p)
    for name, shape in shapes.items():
        q[name] = weight(p[name], name, shape)
    return q


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _global_shapes(cfg):
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.models.transformer import abstract_params
    # outside any active dispatch mode (the dry run's fake tensors and its
    # counting pass): shapes only, counted nowhere
    with _disable_current_modes():
        return _walk(abstract_params(cfg), lambda _, t: t.shape)


def global_shapes(cfg):
    """The shape of every leaf of ``cfg``'s whole params (a tree of
    ``torch.Size`` in the params' structure), from fake tensors."""
    return _global_shapes(cfg)


def _cut(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            i, n = rank_over(mesh, axes)
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
    return t


def _own(block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A strict block gets storage of its own (the whole can be freed);
    a block that is the whole tensor stays that tensor."""
    if block.shape == whole.shape:
        return whole
    return block.clone(memory_format=torch.contiguous_format)


def expert_data_dim(name: str, cfg, mesh) -> Optional[int]:
    """The dim of a rank's hoisted expert block ((1, r, d, f_lp) for
    ``we_up`` / ``we_gate``, (1, r, f_lp, d) for ``we_down``) that
    :func:`place_params` cuts over "data": the reference's FSDP dim of
    the (E, ., .) stack (``_leaf_spec``: d for ``we_up`` / ``we_gate``;
    for ``we_down`` f, or d where "model" already cuts f), one place
    further in the block.  None where "data" cuts none of it (no "data"
    axis, or one that does not divide the block's dim)."""
    from repro_torch.models import moe as moelib   # moe imports this
    sizes = dict(mesh.shape)
    if "data" not in sizes:
        return None
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    down = name == "we_down"
    spec = _leaf_spec((name,), (E, f, d) if down else (E, d, f), sizes)
    if "data" not in spec:
        return None
    _, _, r, f_lp = moelib._layout_dims(cfg, sizes.get("model", 1))
    block = (1, r, f_lp, d) if down else (1, r, d, f_lp)
    dim = spec.index("data") + 1
    return None if block[dim] % sizes["data"] else dim


def place_params(mesh, params: dict, cfg) -> dict:
    """This rank's block of every leaf of ``params`` (the whole tree) on
    ``mesh``, by :func:`param_pspecs`: a dim whose spec names an axis
    keeps this rank's slice along it (the divisibility guard has left a
    dim no axis divides whole).  Every MoE expert stack becomes the
    rank's block of the hoisted layout, row ``local_rank("model")`` of
    ``moe.prepare_tree(params, cfg, M)`` kept as a leading dim of 1
    ((1, r, d, f_lp) for ``we_up`` / ``we_gate``, (1, r, f_lp, d) for
    ``we_down``), cut over "data" on :func:`expert_data_dim`.  A block
    equal to its whole leaf is the caller's tensor; a strict one is a
    copy, except an expert block whole over "data" (a view)."""
    from repro_torch.models import moe as moelib   # moe imports this
    sizes = dict(mesh.shape)
    M = sizes.get("model", 1)
    j = mesh.local_rank("model") if "model" in sizes else 0

    def leaf(path, t):
        name = path[-1]
        if name in _EXPERT_SHARDED:
            if t.dim() != 3:
                raise ValueError(f"{'/'.join(path)}: expected the (E, d, f) "
                                 f"stack, got {tuple(t.shape)}")
            block = moelib.expert_block(t, cfg, M, j,
                                        rows=name == "we_down")[None]
            dim = expert_data_dim(name, cfg, mesh)
            if dim is None or sizes["data"] == 1:
                return block
            spec = [None] * 4
            spec[dim] = "data"
            return _own(_cut(block, tuple(spec), mesh), t)
        spec = _leaf_spec(path, tuple(t.shape), sizes)
        return _own(_cut(t, spec, mesh), t)

    return _walk(params, leaf)


def unplace_params(mesh, placed: dict, cfg) -> dict:
    """The whole tree back from every rank's :func:`place_params` block
    (a collective: every rank of ``mesh`` calls it and gets the whole
    tree).  Works for any tree shaped like the params (their gradients,
    the optimizer's moments)."""
    from repro_torch.models import moe as moelib
    sizes = dict(mesh.shape)
    M = sizes.get("model", 1)
    shapes = global_shapes(cfg)

    def leaf(path, t, shape):
        name = path[-1]
        with torch.no_grad():
            if name in _EXPERT_SHARDED:
                dim = expert_data_dim(name, cfg, mesh)
                if dim is not None and sizes["data"] > 1:
                    t = all_gather(t, mesh, "data", dim)
                hoisted = all_gather(t, mesh, "model", 0) if M > 1 else t
                inv = (moelib.layout_rows_inv if name == "we_down"
                       else moelib.layout_cols_inv)
                return inv(hoisted, cfg, M).contiguous()
            spec = _leaf_spec(path, tuple(shape), sizes)
            for dim, entry in enumerate(spec):
                for ax in reversed(_axes(entry)):
                    if sizes[ax] > 1:
                        t = all_gather(t, mesh, ax, dim)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{'/'.join(path)}: gathered "
                                 f"{tuple(t.shape)}, whole is {tuple(shape)}")
            return t

    return _zip(placed, shapes, leaf)


def split_axes(cfg, mesh):
    """Per leaf of ``cfg``'s params (in their structure), the frozenset of
    mesh axes its placed block is cut on; the MoE expert blocks are cut
    on "model" and on "data" where :func:`expert_data_dim` names a
    dim."""
    sizes = dict(mesh.shape)

    def leaf(path, shape):
        name = path[-1]
        if name in _EXPERT_SHARDED:
            data = expert_data_dim(name, cfg, mesh) is not None
            return frozenset({"model"} & set(sizes)) | (
                frozenset({"data"}) if data else frozenset())
        return frozenset(a for entry in _leaf_spec(path, tuple(shape), sizes)
                         for a in _axes(entry))

    return _walk(global_shapes(cfg), leaf)


def sum_over_data(grads, cfg, mesh):
    """Each rank's gradients, in the params' structure, summed over every
    data-parallel axis its leaf is not cut on (each rank has
    differentiated its own share of the loss; a cut leaf's gather has
    summed its ranks' shares); in place."""
    cut = split_axes(cfg, mesh)
    dp = data_axes(mesh)

    def leaf(path, g, axes):
        for ax in dp:
            if ax not in axes:
                all_reduce(g, mesh, (ax,))
        return g

    with torch.no_grad():
        return _zip(grads, cut, leaf)


def place_states(mesh, states, specs=None):
    """This rank's block of a dense slot pool (``states``: the per-layer
    list of :func:`models.transformer.init_layer_states`), cut by
    :func:`pool_pspecs` (or ``specs``)."""
    specs = specs if specs is not None else pool_pspecs(states, mesh)
    return _zip(states, specs,
                lambda _, t, spec: _own(_cut(t, spec, mesh), t))


def insert_state(mesh, pool, specs, states, i: int) -> None:
    """Write one request's batch-1 ``states`` (from a prefill) into slot
    ``i`` of this rank's block ``pool`` of a pool cut by ``specs``: each
    whole leaf cut along its other dims by its spec (a leaf the prefill
    left as this rank's block, the mLSTM's rows, as it is), and written
    only on the rank whose slot block holds ``i``, in place."""
    for layer, st, spec in zip(pool, states, specs):
        for name, leaf in layer.items():
            sp = spec[name]
            src = st[name]
            # a prefill on the mesh leaves the mLSTM's C / n as the rank's
            # rows already; anything else comes whole
            if tuple(src.shape[1:]) != tuple(leaf.shape[1:]):
                src = _cut(src, (None,) + tuple(sp[1:]), mesh)
            if tuple(src.shape[1:]) != tuple(leaf.shape[1:]):
                raise ValueError(
                    f"a state {name} of shape {tuple(st[name].shape)} does "
                    f"not fit the slot pool's block {tuple(leaf.shape)} "
                    f"(prompt longer than max_len?)")
            axes = _axes(sp[0]) if sp else ()
            if axes:
                owner, local = divmod(i, leaf.shape[0])
                if owner != rank_over(mesh, axes)[0]:
                    continue
            else:
                local = i
            leaf[local].copy_(src[0])
