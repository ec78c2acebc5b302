"""Input specs for every (architecture x input shape): fake tensors.

Port of ``repro/launch/specs.py``.  Where the reference returns
``jax.ShapeDtypeStruct``s, these functions return fake tensors
(``torch._subclasses.fake_tensor``) of the same shapes and dtypes, made
in one ``FakeTensorMode`` (no storage is allocated), and each comes with
its partition spec beside it: a tuple of mesh-axis names per dim, from
``launch/sharding.py``'s ``param_pspecs`` / ``state_pspecs`` and, for
the token inputs, the batch axes of :func:`_batch_axes`.

A mesh here needs only its axis names and sizes (:class:`MeshShape`), no
process group: the dry run sizes a rank's share of the 256- and
512-rank meshes on one CPU.  The port has no ``out_shardings`` to pin;
:func:`output_pspecs` gives the specs of each kind's outputs instead.

Modality carve-outs, as in the reference: [audio] provides the EnCodec
codebook token streams; [vlm] provides precomputed ViT patch embeddings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.optim import tree_map
from repro_torch.launch import sharding as shlib
from repro_torch.models.transformer import abstract_params, init_layer_states
from repro_torch.roofline.analysis import nbytes
from repro_torch.train.optimizer import AdamWState

CPU = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, read as a ``launch.mesh.Mesh`` is
    (``axis_names``, ``shape``, ``size``) by the spec rules."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def tag(self) -> str:
        return "x".join(str(s) for s in self.sizes)


MESHES = {"1x1": MeshShape(("data", "model"), (1, 1)),
          "16x16": MeshShape(("data", "model"), (16, 16)),
          "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16))}


def mesh_shape(tag: str) -> MeshShape:
    if tag not in MESHES:
        raise KeyError(f"unknown mesh {tag!r}; options: {sorted(MESHES)}")
    return MESHES[tag]


def _batch_axes(mesh, global_batch: Optional[int] = None):
    """Batch sharding axes, degrading gracefully when the batch is too
    small to split (long_500k has global_batch=1: replicate)."""
    if mesh is None:
        return "data"
    axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if global_batch is not None:
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if global_batch % size != 0:
            kept = [a for a in axes if global_batch % mesh.shape[a] == 0]
            axes = tuple(kept[:1])  # fall back to one axis or none
            if not axes or global_batch % mesh.shape[axes[0]] != 0:
                return None
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _mode(fake_mode: Optional[FakeTensorMode]) -> FakeTensorMode:
    return fake_mode if fake_mode is not None else FakeTensorMode()


def token_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                fake_mode: Optional[FakeTensorMode] = None
                ) -> Tuple[Dict[str, Any], Dict[str, tuple]]:
    """Model inputs (tokens / patches / labels) for the step kind, and
    their specs: (batch dict, spec dict)."""
    B = shape.global_batch
    dp = _batch_axes(mesh, B)
    S = 1 if shape.kind == "decode" else shape.seq_len
    text_len = S
    out: Dict[str, Any] = {}
    specs: Dict[str, tuple] = {}
    with _mode(fake_mode):
        if cfg.vision_patches and shape.kind != "decode":
            text_len = S - cfg.vision_patches
            assert text_len > 0
            out["patches"] = torch.empty(
                (B, cfg.vision_patches, cfg.vision_dim),
                dtype=getattr(torch, cfg.dtype))
            specs["patches"] = (dp, None, None)
        lead = (B, cfg.num_codebooks) if cfg.num_codebooks else (B,)
        out["tokens"] = torch.empty(lead + (text_len,), dtype=torch.int32)
        specs["tokens"] = (dp,) + (None,) * len(lead)
        if shape.kind == "train":
            out["labels"] = torch.empty(lead + (S,), dtype=torch.int32)
            specs["labels"] = specs["tokens"]
            if cfg.vision_patches:
                out["mask"] = torch.empty((B, S), dtype=torch.float32)
                specs["mask"] = (dp, None)
    return out, specs


def state_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                fake_mode: Optional[FakeTensorMode] = None):
    """Decode-shape layer states: a ``seq_len``-deep cache, every row at
    position ``seq_len - 1`` (one 0-d ``pos`` a layer, as the
    reference's), and their specs."""
    assert shape.kind == "decode"
    with _mode(fake_mode):
        states = init_layer_states(cfg, shape.global_batch, shape.seq_len,
                                   CPU, filled_pos=shape.seq_len - 1)
    return states, shlib.state_pspecs(
        states, mesh, batch_axes=_batch_axes(mesh, shape.global_batch))


def param_specs(cfg: ModelConfig, mesh=None,
                fake_mode: Optional[FakeTensorMode] = None):
    """The params as fake tensors, and :func:`shlib.param_pspecs`."""
    params = abstract_params(cfg, fake_mode)
    return params, shlib.param_pspecs(params, mesh)


def opt_state_specs(params, pspecs, fake_mode: Optional[FakeTensorMode]
                    = None):
    """AdamW state mirrors params twice in f32 (mu, nu) + a step counter;
    the moments take their params' specs."""
    with _mode(fake_mode):
        f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32),
                       params)
        state = AdamWState(step=torch.empty((), dtype=torch.int32), mu=f32,
                           nu=tree_map(torch.empty_like, f32))
    return state, AdamWState(step=(), mu=pspecs, nu=pspecs)


def output_pspecs(cfg: ModelConfig, shape: InputShape, mesh, out) -> object:
    """Specs of a step's outputs ``out`` (fake or real tensors), the
    counterpart of the reference's ``output_shardings``: train
    (params, opt state, metrics), prefill (last logits, states), decode
    (logits, tokens, states).  Logits shard the vocabulary on "model"."""
    dp = _batch_axes(mesh, shape.global_batch)

    def logits_spec(x):
        return (dp, None, "model") if x.dim() == 3 else (dp, "model")

    if shape.kind == "train":
        params, opt, metrics = out
        pspec = shlib.param_pspecs(params, mesh)
        return (pspec, AdamWState(step=(), mu=pspec, nu=pspec),
                {k: () for k in metrics})
    if shape.kind == "prefill":
        logits, states = out
        return (logits_spec(logits),
                shlib.state_pspecs(states, mesh, batch_axes=dp))
    logits, tok, states = out
    return (logits_spec(logits), (dp, None) if tok.dim() == 2 else (dp,),
            shlib.state_pspecs(states, mesh, batch_axes=dp))


def input_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                fake_mode: Optional[FakeTensorMode] = None
                ) -> Tuple[tuple, dict, tuple]:
    """(args, kwargs, specs of args) for the shape's step function,
    params included; every tensor a fake one of ``fake_mode`` (a new mode
    unless one is given: run the step inside the same mode)."""
    from repro_torch.models.transformer import config_for_shape
    cfg = config_for_shape(cfg, shape)
    fake_mode = _mode(fake_mode)
    p, p_spec = param_specs(cfg, mesh, fake_mode)
    toks, t_spec = token_specs(cfg, shape, mesh, fake_mode)
    if shape.kind == "train":
        opt, o_spec = opt_state_specs(p, p_spec, fake_mode)
        return (p, opt, toks), {}, (p_spec, o_spec, t_spec)
    if shape.kind == "prefill":
        return (p, toks), {}, (p_spec, t_spec)
    st, s_spec = state_specs(cfg, shape, mesh, fake_mode)
    return (p, toks, st), {}, (p_spec, t_spec, s_spec)


# ---------------------------------------------------------------------------
# bytes, whole and per rank
# ---------------------------------------------------------------------------


def _pairs(tree, specs):
    """(tensor, spec) for every tensor leaf of ``tree``; ``specs`` shares
    its structure down to the leaves, where it holds a tuple."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def _shards(spec, mesh) -> int:
    """How many ways a leaf with ``spec`` is cut on ``mesh``."""
    n = 1
    for entry in spec or ():
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and mesh is not None:
                n *= mesh.shape.get(axis, 1)
    return n


def argument_bytes(args, specs, mesh=None) -> Tuple[int, int]:
    """(all ranks' bytes, one rank's bytes) of ``args``: a leaf of n bytes
    cut k ways by its spec holds ceil(n / k) bytes on a rank."""
    total = rank = 0
    for t, spec in _pairs(args, specs):
        n = nbytes(t)
        total += n
        rank += -(-n // _shards(spec, mesh))
    return total, rank
