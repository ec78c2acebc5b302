"""The yardstick's arithmetic: the H100's peaks, the bytes and FLOPs of a
kernel call counted from its shapes, and the keys a span of positions
attends.  A model's own FLOPs are its kind's (``models/<kind>.py``'s
``flops``).

Frozen copies of the port's own counts (``repro_torch/bench/kernels.py``
``bound`` and its per-call counts, ``repro_torch/launch/mesh.py``'s
peaks), kept here so that a later change to the program cannot move the
yardstick.  ``test_perfbench_roofline.py`` holds them to the originals
at each cell's shapes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, HBM3
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12


def bound_s(nbytes: float, flops: float,
            peak: float = PEAK_FLOPS_BF16) -> Tuple[float, str]:
    """The least time of a call, in seconds, and what sets it: the bytes
    at the HBM rate or the FLOPs at ``peak``, whichever is longer."""
    t_bytes = nbytes / HBM_BW
    t_flops = flops / peak
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def attn_pairs(Sq: int, Skv: int, window, q_offset: int) -> int:
    """The (query, key) pairs a causal mask admits: query i at position
    ``q_offset + i`` reads keys ``max(0, pos - window + 1) .. min(pos,
    Skv - 1)``."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Skv - 1)
    lo = np.zeros_like(qpos) if window is None else np.maximum(
        qpos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(B: int, H: int, KV: int, Sq: int, Skv: int,
                         hd: int, window, q_offset: int,
                         elem: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ``flash_attention`` call: q read and the
    output written, k and v read once, at ``elem`` bytes an element;
    4 FLOPs a head dimension for each admitted (query, key) pair."""
    pairs = attn_pairs(Sq, Skv, window, q_offset)
    q_numel = B * H * Sq * hd
    kv_numel = B * KV * Skv * hd
    return elem * (2 * q_numel + 2 * kv_numel), 4 * B * H * hd * pairs


def paged_decode_cost(B: int, H: int, KV: int, hd: int, page_size: int,
                      W: int, lengths: Sequence[int],
                      elem: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ``paged_flash_decode`` call: q read and the
    output written, the K and V of the positions the lanes' lengths
    reference (each capped at the table's ``W * page_size``), the int32
    tables and lengths; 4 FLOPs a head dimension a key a query head."""
    ctx = sum(min(int(n), W * page_size) for n in lengths)
    nbytes = (2 * B * H * hd * elem + 2 * ctx * KV * hd * elem
              + B * W * 4 + B * 4)
    return nbytes, 4 * ctx * H * hd


def span_keys(first: int, last: int) -> int:
    """Keys attended by the tokens at positions ``first .. last - 1`` of
    one sequence, each reading every earlier position and itself: the sum
    of ``p + 1``."""
    if last <= first:
        return 0
    return (last * (last + 1) - first * (first + 1)) // 2
