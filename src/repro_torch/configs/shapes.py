"""The four assigned input shapes (the port's copy of
``repro/configs/shapes.py``).

Each shape selects a *step kind*:
  * train   -> train_step   (forward+backward+optimizer)
  * prefill -> serve_prefill (forward, emit KV cache / recurrent state)
  * decode  -> serve_decode  (ONE new token against a seq_len-deep cache)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __str__(self) -> str:
        return f"{self.name}(S={self.seq_len}, B={self.global_batch}, {self.kind})"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; options: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


def smoke_shape(kind: str) -> InputShape:
    """Tiny shape of the same kind for CPU smoke tests."""
    return {
        "train": InputShape("smoke_train", 64, 2, "train"),
        "prefill": InputShape("smoke_prefill", 64, 2, "prefill"),
        "decode": InputShape("smoke_decode", 64, 2, "decode"),
    }[kind]
