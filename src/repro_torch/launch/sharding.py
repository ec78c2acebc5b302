"""Logical-axis sharding rules and the placement of weights on a mesh.

Port of ``repro/launch/sharding.py``.  A :class:`ShardingContext` maps the
models' logical axis names ("batch", "heads", "ff", ...) to mesh axes, as
the reference's does, and :func:`use` makes one current for the steps run
inside it; the MoE layer reads it to pick its sharded path.

The rule functions (:func:`param_pspecs`, :func:`state_pspecs`) give, leaf
for leaf, the reference's ``PartitionSpec`` as a tuple of mesh-axis names
(``None`` for a replicated dim).  They are the plan; what the port places
today is narrower (ROADMAP.md A7b): :func:`place_params` hands each rank
its slice of the MoE expert weights (experts on "model", each expert's
FFN columns on "model" when there are fewer experts than "model" ranks)
and keeps every other weight, the KV caches and the activations whole on
every rank.  So :func:`act` is a no-op.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

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


class ShardingContext:
    def __init__(self, mesh, rules: Optional[Dict[str, object]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        # on a multi-pod mesh, "batch" spans both pod and data axes
        if "pod" in mesh.axis_names and self.rules.get("batch") == "data":
            self.rules["batch"] = ("pod", "data")

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)


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
    """The reference's activation-sharding constraint.  Activations are
    replicated on every rank of the port's meshes, so this returns ``x``
    unchanged, inside a context or not."""
    return x


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
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


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
        batch_axes = ("pod", "data") if (mesh is not None and
                                         "pod" in mesh.axis_names) else "data"
    sizes = dict(mesh.shape) if mesh is not None else None
    return _walk(states, lambda path, leaf: _state_leaf_spec(
        path, tuple(leaf.shape), batch_axes, sizes))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def place_params(mesh, params: dict, cfg) -> dict:
    """This rank's params on ``mesh``: every MoE expert stack becomes the
    rank's block of the hoisted layout, row ``local_rank("model")`` of
    ``moe.prepare_tree(params, cfg, M)`` kept as a leading dim of 1
    ((1, r, d, f_lp) for ``we_up`` / ``we_gate``, (1, r, f_lp, d) for
    ``we_down``), cut from the (E, d, f) stack without building the
    whole layout.  Every other leaf is the caller's tensor, whole."""
    from repro_torch.models import moe as moelib   # moe reads current()
    if cfg.moe is None:
        return params
    M = mesh.shape["model"]
    j = mesh.local_rank("model")

    def block(ffn: dict) -> dict:
        if "we_up" not in ffn:
            return ffn
        out = dict(ffn)
        for name in ("we_up", "we_gate", "we_down"):
            if name in ffn:
                out[name] = moelib.expert_block(
                    ffn[name], cfg, M, j, rows=name == "we_down")[None]
        return out

    placed = dict(params)
    placed["layers"] = [
        {**layer, "ffn": block(layer["ffn"])} if "ffn" in layer else layer
        for layer in params["layers"]]
    return placed
