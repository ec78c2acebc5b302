"""The yardstick's arithmetic: the H100's peaks, the bytes and FLOPs of a
kernel call counted from its shapes, and a model's FLOPs per token.

Frozen copies of the port's own counts (``repro_torch/bench/kernels.py``
``bound`` and its per-call counts, ``repro_torch/launch/mesh.py``'s
peaks, ``repro_torch/configs/base.py``'s ``param_count`` and
``repro_torch/roofline/analysis.py``'s ``model_flops``), kept here so
that a later change to the program cannot move the yardstick.
``test_perfbench_roofline.py`` holds them to the originals at each
cell's shapes.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def param_count(spec: Dict) -> int:
    """Parameters of a dense decoder of ``spec`` (``model.spec``'s keys),
    as the port's ``ModelConfig.param_count`` counts them: the embedding,
    the head unless tied, per layer the q/k/v/o projections, the MLP (3
    matrices gated, 2 not) and two norm scales; QKV biases and the final
    norm are not counted."""
    d, f, V = spec["d_model"], spec["d_ff"], spec["vocab"]
    H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    n = V * d + (0 if spec["tied"] else d * V)
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d
                 + (3 if spec["gated"] else 2) * d * f + 2 * d)
    return n + spec["layers"] * per_layer


def model_flops(spec: Dict, kind: str, tokens: int) -> float:
    """``roofline/analysis.py``'s MODEL_FLOPS: 6 N D to train, 2 N D to
    infer, N the parameters, D the tokens."""
    n = param_count(spec)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def matmul_params(spec: Dict) -> int:
    """The parameters a token multiplies: every projection and MLP
    matrix, and the head (the embedding matrix itself where tied); not
    the embedding lookup, the norms or the biases."""
    d, f, V = spec["d_model"], spec["d_ff"], spec["vocab"]
    H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d
                 + (3 if spec["gated"] else 2) * d * f)
    return spec["layers"] * per_layer + d * V


def sequence_flops(spec: Dict, tokens: int, keys: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend ``keys`` keys in all:
    2 per matmul parameter per token, and in every layer 4 per head
    dimension per query head per key (scores and the weighted sum)."""
    return (2.0 * matmul_params(spec) * tokens
            + 4.0 * spec["head_dim"] * spec["heads"] * spec["layers"] * keys)


def span_keys(first: int, last: int) -> int:
    """Keys attended by the tokens at positions ``first .. last - 1`` of
    one sequence, each reading every earlier position and itself: the sum
    of ``p + 1``."""
    if last <= first:
        return 0
    return (last * (last + 1) - first * (first + 1)) // 2
