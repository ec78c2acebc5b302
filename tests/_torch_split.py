"""Helpers for the split-K decode tests: a plain PyTorch mirror of what
the split and merge kernels compute (``csrc/decode_split.cuh``), and a
CUDA-graph replay check.  PyTorch only, so that the ``cuda`` tests that use
it also collect on a machine without JAX.
"""
from __future__ import annotations

import math

import torch


def split_merge_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, per_split: int,
                       n_splits: int) -> torch.Tensor:
    """Split-then-merge decode over dense caches, in f32.

    q (B,H,hd); k, v (B,KV,S,hd); lengths (B,).  Split s of lane b covers
    positions [s * per_split, min((s + 1) * per_split, len_b)) and writes
    its (m, l, acc); a split starting at or past len_b writes nothing, so
    its partial keeps the NaN the buffers start with, and the merge must
    skip it.  Returns (B,H,hd) in q's dtype; a lane of length 0 gives
    zeros."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    nan = float("nan")
    acc = torch.full((B, KV, n_splits, G, hd), nan)
    m = torch.full((B, KV, n_splits, G), nan)
    l = torch.full((B, KV, n_splits, G), nan)  # noqa: E741
    qh = q.reshape(B, KV, G, hd).float()
    lens = [min(max(int(n), 0), S) for n in lengths.tolist()]
    for b, n in enumerate(lens):
        for s in range(n_splits):
            lo = s * per_split
            if lo >= n:
                continue
            hi = min(lo + per_split, n)
            sc = torch.einsum("kgd,kjd->kgj", qh[b],
                              k[b, :, lo:hi].float()) / math.sqrt(hd)
            m[b, :, s] = sc.amax(-1)
            e = torch.exp(sc - m[b, :, s, :, None])
            l[b, :, s] = e.sum(-1)
            acc[b, :, s] = torch.einsum("kgj,kjd->kgd", e,
                                        v[b, :, lo:hi].float())
    out = torch.zeros(B, KV, G, hd)
    for b, n in enumerate(lens):
        live = min(n_splits, -(-n // per_split))
        if live == 0:
            continue
        w = torch.exp(m[b, :, :live] - m[b, :, :live].amax(1, keepdim=True))
        out[b] = ((w[..., None] * acc[b, :, :live]).sum(1)
                  / (w * l[b, :, :live]).sum(1)[..., None])
    return out.reshape(B, H, hd).to(q.dtype)


# how the mirror tests cut a cache: the kernels' own plan, runs of three
# units, or one split per lane
PLANS = {"rule": None, "three_units": 3, "one_split": 1 << 20}


def plan_for(split_plan, how, KV: int, n_positions: int, unit: int):
    """(per_split, n_splits) for 6 lanes by ``PLANS[how]``."""
    if PLANS[how] is None:
        return split_plan(6, KV, n_positions, unit)
    per = min(PLANS[how], -(-n_positions // unit)) * unit
    return per, -(-n_positions // per)


def boundary_lengths(per_split: int, n_positions: int) -> list:
    """Lane lengths 0, 1, at the first split boundary, one past it, one
    short of the second, and full."""
    picks = [0, 1, per_split, per_split + 1, 2 * per_split - 1, n_positions]
    return [min(n, n_positions) for n in picks]


def poison_cache(q: torch.Tensor, n_splits: int) -> None:
    """Leave NaN where a decode wrapper's next call will allocate: a
    tensor like its output and one of its partials' workspace (f32,
    B * H * n_splits * (hd + 2)), filled with NaN and freed, in the order
    the wrapper allocates them, so that the caching allocator hands the
    wrapper's own ``torch.empty`` calls these blocks back.  A merge that
    read the partial of a split that returned early would then give NaN
    rather than pass on zeros or stale finite data."""
    B, H, hd = q.shape
    blocks = [torch.full_like(q, float("nan")),
              torch.full((B * H * n_splits * (hd + 2),), float("nan"),
                         dtype=torch.float32, device=q.device)]
    del blocks


def graph_replay(fn) -> torch.Tensor:
    """``fn()`` captured in a CUDA graph and replayed once; its output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def check_plan(decode_attention, B: int, KV: int, unit: int,
               n_positions: int) -> None:
    """``split_plan``'s splits cover positions [0, n_positions) exactly
    once, each a whole number of ``unit``s and at most ``MAX_SPLIT``
    positions (or one unit), none empty at full length; the blocks stay
    within ``SPLIT_BLOCKS`` unless the cap on a split's length binds, and
    no fewer positions per split would keep within them."""
    max_blocks = decode_attention.SPLIT_BLOCKS
    max_split = decode_attention.MAX_SPLIT
    per, n = decode_attention.split_plan(B, KV, n_positions, unit)
    cap = max(unit, max_split // unit * unit)
    assert per > 0 and per % unit == 0 and per <= cap
    assert 1 <= n <= 65535
    assert (n - 1) * per < n_positions <= n * per
    assert B * KV * n <= max(max_blocks, B * KV) or per == cap
    if per > unit:
        smaller = -(-n_positions // (per - unit))
        assert B * KV * smaller > max_blocks
