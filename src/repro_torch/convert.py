"""Carry JAX parameters and agent states over to the port.

``params_from_jax`` takes the reference's parameter tree with numpy
leaves (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's tree: the same keys and the same ``(in, out)`` weight layout, with
the layers as one flat list.  It takes both of the reference's layer
layouts:

* ``{"flat": [layer, ...]}`` (``scan_layers=False``, what ``reduced()``
  gives), and
* ``{"scan": [stacked, ...], "rem": [layer, ...]}`` (every full config):
  ``scan[j]`` holds the layers ``g * P + j`` stacked on a leading axis,
  with ``P = len(cfg.pattern)``; the ``rem`` layers follow them.  A MoE
  layer's stacked (G, E, d, f) expert leaves unstack like any other.

``agent_states_from_jax`` takes the reference's stacked agent state (the
vmapped ``LadtsState`` / ``SacState`` / ``DqnState`` of
``repro.core.trainer.init_agents``, numpy leaves) and returns the port's:
the same NamedTuples by field name, integers as int64.

``params_to_jax`` is the way back: the port's tree restacked into either
of the reference's layouts, numpy leaves; checkpoints and gradient
comparisons go through it (``stack_layers`` keeps the leaves tensors).
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import agents as ag
from repro_torch.core.optim import AdamState
from repro_torch.core.replay import ReplayState


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _take(a, g: int):
    return a[g] if isinstance(a, torch.Tensor) else np.asarray(a)[g]


def unstack_layers(layers: dict, cfg) -> List[Any]:
    """The reference's layer tree of either layout (numpy or tensor
    leaves) -> one flat list of layers; a scanned leaf's layers are views
    of it."""
    if "flat" in layers:
        return list(layers["flat"])
    P = len(cfg.pattern)
    n_groups = cfg.num_layers // P
    flat: List[Any] = [None] * (n_groups * P)
    for j, stacked in enumerate(layers["scan"]):
        for g in range(n_groups):
            flat[g * P + j] = _map(stacked, lambda a, g=g: _take(a, g))
    flat += list(layers["rem"])
    if len(flat) != cfg.num_layers:
        raise ValueError(f"layer tree holds {len(flat)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return flat


def params_from_jax(tree: dict, cfg, device) -> dict:
    """Reference parameter tree (numpy leaves) -> port params on
    ``device``."""
    device = torch.device(device)
    out = {k: _map(v, lambda a: _to_tensor(a, device))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(layer, lambda a: _to_tensor(a, device))
                     for layer in unstack_layers(tree["layers"], cfg)]
    return out


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, [t[i] for t in trees])
                for i in range(len(first))]
    return fn(*trees)


def stack_layers(layers: List[Any], cfg, layout: str) -> dict:
    """The port's flat layer list -> the reference's layer tree of
    ``layout``: ``"flat"`` ({"flat": [...]}) or ``"scan"`` ({"scan":
    [...], "rem": [...]}, ``scan[j]`` stacking layers ``g * P + j``), the
    inverse of :func:`unstack_layers`.  Leaves stay tensors."""
    if layout == "flat":
        return {"flat": list(layers)}
    if layout != "scan":
        raise ValueError(f"unknown layer layout {layout!r}; options "
                         f"('flat', 'scan')")
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers, config {cfg.name} has "
                         f"{cfg.num_layers}")
    P = len(cfg.pattern)
    n_groups = cfg.num_layers // P
    scan = [] if n_groups == 0 else [
        _zip_map(lambda *ls: torch.stack(ls),
                 [layers[g * P + j] for g in range(n_groups)])
        for j in range(P)]
    return {"scan": scan, "rem": list(layers[n_groups * P:])}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:     # as ml_dtypes' bf16 (the reference's)
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_jax(params: dict, cfg, layout: str) -> dict:
    """Port params -> the reference's parameter tree with numpy leaves,
    the inverse of :func:`params_from_jax`: the layer list restacked in
    ``layout`` (:func:`stack_layers`).  bf16 leaves come out as
    ``ml_dtypes.bfloat16`` arrays, which needs that package."""
    tree = {k: v for k, v in params.items() if k != "layers"}
    tree["layers"] = stack_layers(params["layers"], cfg, layout)
    return _map(tree, _to_numpy)


_STATE_TYPES = {"LadtsState": ag.LadtsState, "SacState": ag.SacState,
                "DqnState": ag.DqnState, "AdamState": AdamState,
                "ReplayState": ReplayState, "Transition": ag.Transition}
_METHOD_STATE = {"lad-ts": "LadtsState", "d2sac-ts": "LadtsState",
                 "sac-ts": "SacState", "dqn-ts": "DqnState"}


def _state(tree, device: torch.device):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        port = _STATE_TYPES[type(tree).__name__]
        if tuple(port._fields) != tuple(tree._fields):
            raise ValueError(f"{type(tree).__name__} fields "
                             f"{tree._fields} != the port's {port._fields}")
        return port(*(_state(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: _state(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_state(v, device) for v in tree]
    t = _to_tensor(tree, device)
    return t.to(torch.int64) if not t.is_floating_point() else t


def agent_states_from_jax(states, method: str, device: DeviceLike = None):
    """Reference stacked agent state (numpy leaves) of ``method`` -> the
    port's state on ``device`` (``cuda`` unless the caller asks for the
    CPU: :func:`repro_torch.resolve_device`)."""
    want = _METHOD_STATE[method]
    if type(states).__name__ != want:
        raise ValueError(f"{method} keeps a {want}, got "
                         f"{type(states).__name__}")
    return _state(states, resolve_device(device))
