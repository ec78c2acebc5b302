"""PyTorch + CUDA port of the JAX reproduction package ``repro``.

The port mirrors ``repro``'s file names so each module has exactly one
reference module; it imports ``torch`` and ``numpy`` and nothing of JAX or
of ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise
instead of quietly falling back (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise the device
    asked for, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
