"""Flat-npz checkpoints of params, optimizer state and step, in the
reference's file format.

Port of ``repro/train/checkpoint.py``.  The file is the reference's: one
npz, keys ``params/<path>`` and ``opt/<path>`` with the tree path joined
by "/", the layers in the reference's layout for the config
(``layers/flat/<i>/...``, or ``layers/scan/<j>/...`` and
``layers/rem/<i>/...`` for a config that scans its layers), the optimizer state
as ``opt/step``, ``opt/mu/...`` and ``opt/nu/...``, bf16 leaves stored as
their ``uint16`` bits under the key plus ``__bf16__``, and ``__step__``.
So the reference restores what the port saves, and the other way round.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import stack_layers, unstack_layers
from repro_torch.train.optimizer import AdamWState

_BF16_TAG = "__bf16__"


def _reference_tree(params, cfg) -> dict:
    tree = {k: v for k, v in params.items() if k != "layers"}
    tree["layers"] = stack_layers(params["layers"], cfg,
                                  "scan" if cfg.scan_layers else "flat")
    return tree


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        key = prefix[:-1]
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()


def _opt_tree(opt_state: AdamWState, cfg) -> dict:
    return {"step": opt_state.step, "mu": _reference_tree(opt_state.mu, cfg),
            "nu": _reference_tree(opt_state.nu, cfg)}


def save_checkpoint(path: str, params, cfg,
                    opt_state: Optional[AdamWState] = None,
                    step: int = 0) -> None:
    """Write params (and ``opt_state``) of ``cfg`` at ``step`` to
    ``path``, atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs: Dict[str, np.ndarray] = {}
    _flatten(_reference_tree(params, cfg), "params/", blobs)
    if opt_state is not None:
        _flatten(_opt_tree(opt_state, cfg), "opt/", blobs)
    blobs["__step__"] = np.asarray(step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)


def _rebuild(like, prefix: str, blobs, device) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", blobs, device)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, f"{prefix}{i}/", blobs, device)
                for i, v in enumerate(like)]
    key = prefix[:-1]
    if key + _BF16_TAG in blobs:
        t = torch.from_numpy(blobs[key + _BF16_TAG].view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(blobs[key]))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(like.shape)}")
    return t.to(device)


def _unstack(tree, cfg) -> dict:
    """The reference's layer tree (tensor leaves) -> the port's list."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = unstack_layers(tree["layers"], cfg)
    return out


def restore_checkpoint(path: str, params_like, cfg,
                       opt_like: Optional[AdamWState] = None
                       ) -> Tuple[Any, Optional[AdamWState], int]:
    """Restore into the structure, shapes and device of ``params_like``
    (and ``opt_like``); returns (params, opt_state or None, step).  Reads
    a checkpoint the reference wrote as well as the port's own."""
    with np.load(path) as z:
        blobs = {k: z[k] for k in z.files}
    step = int(blobs.pop("__step__", 0))
    device = params_like["embed"]["embed"].device
    params = _unstack(_rebuild(_reference_tree(params_like, cfg), "params/",
                               blobs, device), cfg)
    opt = None
    if opt_like is not None:
        tree = _rebuild(_opt_tree(opt_like, cfg), "opt/", blobs, device)
        opt = AdamWState(step=tree["step"], mu=_unstack(tree["mu"], cfg),
                         nu=_unstack(tree["nu"], cfg))
    return params, opt, step
