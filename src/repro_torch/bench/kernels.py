"""Kernel microbenchmarks of the port, and the kernels' shapes.

Port of ``benchmarks/kernels.py``.  :func:`bench_kernels` runs the four
kernels at the reference's bench shapes (flash attention at B 1, H 4,
KV 2, S 512, hd 64; flash decode at 2 x 2048; paged decode at 2048
tokens, page 64; the LADN chain at T 256, I 5, S 22, A 20, hidden
(20, 20)) and at the main path's shapes, the tables below, which
``chip_smoke.py`` reads from here too (one copy).  Each row gives the
kernel's time, the plain version's time, the bound (each input read and
the output written once at the HBM rate, or the FLOPs at the dtype's
peak, whichever is longer; f32 ``flash_attention`` at the tensor cores'
3xTF32 rate, its arithmetic) and, for the attention kernels, SDPA's time
on the same inputs.

Each row labels what it ran, as the reference labels ``interpret_mode``:
``cuda`` on the card, where the kernel (called directly, so the launch
counters of ``kernels/ops.py`` do not move) is held to its plain version;
``plain-cpu`` on the CPU, where both columns are the plain version.
Times on the card come from CUDA-graph replay between CUDA events; on
the CPU from the wall clock.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32, PEAK_FLOPS_F32_TC)

PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}    # tests/test_kernels.py:45
LADN_TOL = 1e-4

# ---------------------------------------------------------------------------
# the main path's shapes
# ---------------------------------------------------------------------------

# main-path shapes of paged_flash_decode under chip_smoke.py phase 4's
# serve flags: max_lanes 8, qwen2-1.5b heads, page 16, max_len 128 + 32 =
# 160 -> 1 + 4 * 10 pages and a 10 + 4 + 1 wide block table
B, H, KV, HD, PS, P, W = 8, 12, 2, 128, 16, 41, 15
# paged_flash_decode's shapes (B, H, KV, hd, ps, P, W, lengths): the
# serve path's (ragged, with a 1-token lane and a full table), and the
# same heads at 8 lanes of 2048 tokens (W 128, P = 1 + 8 * 128)
PAGED_SHAPES = {
    "serve": (B, H, KV, HD, PS, P, W, (1, W * PS, 37, 16, 17, 100, 2, 160)),
    "long_2048": (8, H, KV, HD, PS, 1 + 8 * 128, 128, (2048,) * 8),
    # the closed loop's paged engines: 8 lanes, page 8, max_len
    # 3 * (32 + 8) = 120 -> 1 + 2 * 15 pages and a 15 + 2 + 1 wide table,
    # at qwen2-1.5b's heads and at starcoder2-3b's
    "qwen2_closedloop": (8, H, KV, HD, 8, 31, 18,
                         (1, 120, 37, 16, 17, 64, 2, 88)),
    "starcoder2_3b": (8, 24, 2, 128, 8, 31, 18,
                      (1, 120, 37, 16, 17, 64, 2, 88)),
    # the paged crash drill (run in f32): 8 lanes, page 16, max_len
    # 64 + 12 = 76 -> 1 + 4 * 5 pages and a 5 + 1 + 1 wide table
    "crash_qwen2": (8, H, KV, HD, 16, 21, 7, (65, 76, 70, 64, 17, 40, 1, 1)),
    # the chaos and stress benches' paged engines (bf16): 8 lanes, page
    # 16, max_len 3 * (16 + 6) = 66 -> 1 + 2 * 5 pages and a 5 + 1 + 1
    # wide table, at qwen2-1.5b's heads and at starcoder2-3b's
    "chaos_qwen2": (8, H, KV, HD, 16, 11, 7, (1, 66, 37, 16, 17, 38, 2, 23)),
    "chaos_sc2": (8, 24, 2, 128, 16, 11, 7, (1, 66, 37, 16, 17, 38, 2, 23)),
    # the paged dbrx-132b engine (H 48 over KV 8): 8 lanes, page 16,
    # max_len 128 + 16 = 144 -> 1 + 4 * 9 pages and a 9 + 4 + 1 wide
    # table; the pages admit 4 requests at a time, so 4 lanes idle
    "dbrx_round": (8, 48, 8, 128, 16, 37, 14,
                   (129, 137, 144, 130, 0, 0, 0, 0)),
    # Table V's engines at published width: 8 lanes, page 16, max_len
    # 16 + 8 = 24 -> 1 + 4 * 2 pages and a 2 + 4 + 1 wide table; four
    # lanes busy (one 16-token prompt's first step, two near the end), the
    # idle lanes at the null page
    "tablev_round": (8, H, KV, HD, 16, 9, 7, (17, 23, 23, 23, 1, 1, 1, 1)),
}

# ladn_denoise's shapes on the LAD-TS path (G agents, T rows, I steps,
# A actions, S state, H hidden): one decision per agent at a task step;
# the update's K = 64 no-grad chains per agent; one live placement
# (serve.build_scheduler: 2 engines, I = 3); and the closed loop's, on
# the QoS observation of 4 edges (S = 3 + 2 * 4, I = 3): acting and the
# update in the QoS simulator, one live placement
LADN_SHAPES = {"act": (20, 1, 5, 20, 22, 20),
               "update": (20, 64, 5, 20, 22, 20),
               "live": (1, 1, 3, 2, 4, 20),
               "cl_act": (4, 1, 3, 4, 11, 20),
               "cl_update": (4, 64, 3, 4, 11, 20),
               "cl_live": (1, 1, 3, 4, 11, 20),
               # the chaos serve's, on the availability observation of 2
               # edges (S = 2 + 2 * 2, I = 3): acting and the update in
               # the fault-enabled simulator, one live placement
               "chaos_act": (2, 1, 3, 2, 6, 20),
               "chaos_update": (2, 64, 3, 2, 6, 20),
               "chaos_live": (1, 1, 3, 2, 6, 20)}
# and one shape above 32 wide, for the shared-memory instantiation (no
# main path reaches it; T 33 leaves the last block ragged)
LADN_WIDE = {"wide": (4, 33, 7, 40, 70, 64)}

# flash_attention's shapes (B, H, KV, Sq, Skv, hd, window, q_offset, dtype):
# recurrentgemma's dense prefill of 128-token prompts, the same heads
# where the 2048 window bites, qwen2's paged prefill chunk (64 queries at
# offset 64 against the 15 x 16-token table) and the last chunk of a
# 2048-token qwen2 prompt (offset 1984, a 128-page table)
ATTN_SHAPES = {
    "rg_prefill": (1, 16, 1, 128, 128, 256, 2048, 0, "bfloat16"),
    "rg_4096": (1, 16, 1, 4096, 4096, 256, 2048, 0, "bfloat16"),
    "qwen2_chunk": (1, 12, 2, 64, 240, 128, None, 64, "bfloat16"),
    "qwen2_chunk_2048": (1, 12, 2, 64, 2048, 128, None, 1984, "bfloat16"),
    "rg_prefill_f32": (1, 16, 1, 128, 128, 256, 2048, 0, "float32"),
    # the closed loop's paged engines: the last 16-token chunk of a
    # 64-token prompt against the 18 x 8-token table, at qwen2-1.5b's
    # heads and at starcoder2-3b's
    "qwen2_cl_chunk": (1, 12, 2, 16, 144, 128, None, 48, "bfloat16"),
    "sc2_chunk": (1, 24, 2, 16, 144, 128, None, 48, "bfloat16"),
    # the multimodal dense prefills: llava-next-mistral-7b's 576 patches
    # and 64-token prompt (H 32 over KV 8, hd 128), musicgen-large's
    # 128-token prompt (MHA, hd 64)
    "llava_prefill": (1, 32, 8, 640, 640, 128, None, 0, "bfloat16"),
    "musicgen_prefill": (1, 32, 32, 128, 128, 64, None, 0, "bfloat16"),
    # the crash drills (f32): the paged qwen2 chunk (16 queries at offset
    # 48 against the 7 x 16-token table) and recurrentgemma's dense
    # prefills of the 64-token prompts and of the 16-token gated one
    "crash_qwen2_chunk_f32": (1, 12, 2, 16, 112, 128, None, 48, "float32"),
    "crash_rg_prefill_f32": (1, 16, 1, 64, 64, 256, 2048, 0, "float32"),
    "crash_rg_gate_f32": (1, 16, 1, 16, 16, 256, 2048, 0, "float32"),
    # the chaos and stress benches' paged engines: an 8-token chunk at
    # offset 8 against the 7 x 16-token table, at qwen2-1.5b's heads and
    # at starcoder2-3b's
    "chaos_qwen2_chunk": (1, 12, 2, 8, 112, 128, None, 8, "bfloat16"),
    "chaos_sc2_chunk": (1, 24, 2, 8, 112, 128, None, 8, "bfloat16"),
    # MoE (H 48 over KV 8, hd 128): mixtral-8x22b's dense 128-token
    # prefill (window 4096) and dbrx-132b's second 64-token chunk against
    # the 14 x 16-token table, in bf16 and in f32, and the f32 train-mode
    # forwards over 4 x (128 + 15) tokens
    "mixtral_prefill": (1, 48, 8, 128, 128, 128, 4096, 0, "bfloat16"),
    "dbrx_chunk": (1, 48, 8, 64, 224, 128, None, 64, "bfloat16"),
    "mixtral_prefill_f32": (1, 48, 8, 128, 128, 128, 4096, 0, "float32"),
    "dbrx_chunk_f32": (1, 48, 8, 64, 224, 128, None, 64, "float32"),
    "mixtral_forced_f32": (4, 48, 8, 143, 143, 128, 4096, 0, "float32"),
    "dbrx_forced_f32": (4, 48, 8, 143, 143, 128, None, 0, "float32"),
    # the default entry point's, recorded from the ops.flash_attention
    # calls of ``python -m repro_torch.launch.serve --arch <arch> --device
    # cpu`` (without --full-scale it serves the reduced f32 configs):
    # qwen2-1.5b's paged 64-query chunk against 128 keys (H 4, KV 2, hd
    # 64) and recurrentgemma-9b's dense 32-token prefill (H 4, KV 1,
    # window 64)
    "serve_reduced_qwen2_f32": (1, 4, 2, 64, 128, 64, None, 0, "float32"),
    "serve_reduced_rg_f32": (1, 4, 1, 32, 32, 64, 64, 0, "float32"),
    # qwen2-1.5b's train step, one 512-token row a microbatch
    "qwen2_train": (1, 12, 2, 512, 512, 128, None, 0, "bfloat16"),
    # the dry run's qwen2-1.5b prefill at prefill_32k's length, and Table
    # V's 64-token prefill chunk against the 7 x 16-token table
    "qwen2_prefill_32k": (1, 12, 2, 32768, 32768, 128, None, 0, "bfloat16"),
    "tablev_chunk": (1, 12, 2, 64, 112, 128, None, 0, "bfloat16"),
}
# flash_decode's shapes (B, H, KV, W, hd, lengths, dtype): recurrentgemma's
# dense decode round (4 slots, max_len 128 + 32 = 160 -> a 160-slot ring)
# and a wrapped 2048-slot ring
DECODE_SHAPES = {
    "rg_round": (4, 16, 1, 160, 256, (129, 145, 160, 131), "bfloat16"),
    "rg_ring_2048": (4, 16, 1, 2048, 256, (2048,) * 4, "bfloat16"),
    "rg_round_f32": (4, 16, 1, 160, 256, (129, 145, 160, 131), "float32"),
    "rg_ring_2048_f32": (4, 16, 1, 2048, 256, (2048,) * 4, "float32"),
    # the multimodal decode rounds: llava (max_len 576 + 64 + 32 = 672)
    # in bf16, musicgen (160) in f32, its int8 rings dequantised
    "llava_round": (4, 32, 8, 672, 128, (641, 655, 672, 645), "bfloat16"),
    "musicgen_round_f32": (4, 32, 32, 160, 64, (129, 145, 160, 131),
                           "float32"),
    # the dense crash drill: recurrentgemma-9b's 4 slots of a
    # 64 + 12 = 76-slot ring, f32
    "crash_rg_ring_f32": (4, 16, 1, 76, 256, (65, 76, 70, 17), "float32"),
    # the dense mixtral-8x22b round: 4 slots of a 144-slot ring
    # (max_len 128 + 16, under the 4096 window), bf16 and f32
    "mixtral_round": (4, 48, 8, 144, 128, (129, 137, 144, 130), "bfloat16"),
    "mixtral_round_f32": (4, 48, 8, 144, 128, (129, 137, 144, 130),
                          "float32"),
    # the dry run's qwen2-1.5b decode: 8 rows against a full 32768-deep
    # ring (filled_pos 32767, so each row reads all 32768 slots)
    "qwen2_ring_32k": (8, 12, 2, 32768, 128, (32768,) * 8, "bfloat16"),
}

# the reference's bench shapes (benchmarks/kernels.py), f32 as its
# jax.random draws are
BENCH_ATTN = {"S512": (1, 4, 2, 512, 512, 64, None, 0, "float32")}
BENCH_DECODE = {"S2048": (2, 4, 2, 2048, 64, (2048, 2048), "float32")}
# 2 sequences of 32 pages of 64 over a pool of 1 + 2 * 32, scattered
BENCH_PAGED = {"S2048": (2, 4, 2, 64, 64, 65, 32, (2048, 1024))}
BENCH_LADN = {"T256": (1, 256, 5, 20, 22, 20)}

# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call on the card: ``iters`` calls
    captured in a CUDA graph, replayed ``reps`` times between CUDA events,
    so Python and launch overhead stay out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def wall_ms(fn, reps: int = 3) -> float:
    """Wall time of one ``fn()`` call on the CPU, after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bound(nbytes: int, flops: int, dtype: str,
          peak: Optional[float] = None) -> Tuple[float, str]:
    """The least time for a call, in ms, and what sets it: ``nbytes`` at
    the HBM rate or ``flops`` at ``peak`` (default the dtype's data-sheet
    peak)."""
    bytes_ms = nbytes / HBM_BW * 1e3
    flops_ms = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def attention_bound(nbytes: int, flops: int,
                    dtype: str) -> Tuple[float, str]:
    """``flash_attention``'s bound: an f32 call's products are f32-exact
    on the tensor cores through 3xTF32, so its flops go at
    ``PEAK_FLOPS_F32_TC``, not the CUDA cores' rate."""
    if dtype != "float32":
        return bound(nbytes, flops, dtype)
    ms, by = bound(nbytes, flops, dtype, PEAK_FLOPS_F32_TC)
    return ms, by if by == "bytes" else "operations (3xTF32)"


def ladn_bound(G, T, I, A, S, H) -> Tuple[float, str]:  # noqa: E741
    """One chain call: each input read once and the output written once
    at HBM rate, or its f32 flops at the f32 peak."""
    nbytes = 4 * (G * T * (A + S + I * A + A)          # x, s, noise, out
                  + G * I * H                          # temb_w1
                  + G * (A * H + S * H + H * H + H * A + 2 * H + A))
    per_step = 2 * A * H + 2 * H * H + 2 * H * A + 5 * H + 6 * A
    flops = G * T * (2 * S * H + H + I * per_step)
    return bound(nbytes, flops, "float32")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def paged_decode_case(spec, dtype, seed: int = 0, device: DeviceLike = None):
    """Inputs of paged_flash_decode at ``spec`` (a ``PAGED_SHAPES`` entry):
    a random pool, scrambled tables whose unmapped tails hold
    out-of-range ids."""
    Bs, Hs, KVs, hd, ps, Ps, Ws, lens = spec
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    lengths = np.asarray(lens, np.int32)
    tables = np.stack([rng.permutation(np.arange(1, Ps))[:Ws]
                       for _ in range(Bs)]).astype(np.int32)
    for b, ln in enumerate(lengths):      # unmapped tail: out of range
        n = -(-int(ln) // ps)
        tables[b, n:] = rng.choice([-7, Ps, Ps + 1000], size=Ws - n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, kp, vp = (torch.randn(shp, generator=gen, device=dev).to(dtype)
                 for shp in ((Bs, Hs, hd), (Ps, KVs, ps, hd),
                             (Ps, KVs, ps, hd)))
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))


def sdpa_paged_inputs(q, kp, vp, tables, lens):
    """Dense (B, KV, W*ps, hd) K/V gathered through the tables, and the
    length mask, for the library yardstick."""
    Bs, Ws = tables.shape
    Ps, KVs, ps, hd = kp.shape
    tbl = tables.long().clamp(0, Ps - 1)
    k = kp[tbl].permute(0, 2, 1, 3, 4).reshape(Bs, KVs, Ws * ps, hd)
    v = vp[tbl].permute(0, 2, 1, 3, 4).reshape(Bs, KVs, Ws * ps, hd)
    mask = (torch.arange(Ws * ps, device=q.device)[None, :]
            < lens[:, None].long())[:, None, None, :]
    return q[:, :, None, :], k.contiguous(), v.contiguous(), mask


def ladn_case(G, T, I, A, S, H, seed: int = 0,  # noqa: E741
              device: DeviceLike = None):
    """Random stacked LADN weights and rows, in the kernel's argument
    order (the schedule last, as numpy)."""
    from repro_torch.core import networks as nets
    from repro_torch.core.diffusion import make_schedule_np
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    theta = nets.init_ladn(gen, S, A, (H, H), num_agents=G, device=dev)
    x = torch.randn((G, T, A), generator=gen, device=dev)
    s = torch.randn((G, T, S), generator=gen, device=dev)
    noise = torch.randn((G, T, I, A), generator=gen, device=dev)
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, S, A)
    temb_w1 = nets.timestep_embed(torch.arange(I, 0, -1, device=dev),
                                  device=dev) @ w1t
    return (x, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
            make_schedule_np(I))


def attn_mask(Sq, Skv, window, q_offset, dev):
    qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attn_pairs(Sq, Skv, window, q_offset) -> int:
    """The (query, key) pairs ``attn_mask`` admits, counted on the host."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Skv - 1)
    lo = np.zeros_like(qpos) if window is None else np.maximum(
        qpos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


# above this many f32 scores attention_ref's dense (B, H, Sq, Skv) scores
# do not fit beside the inputs (the 32k prefill's would take 51.5 GB)
DENSE_SCORES_MAX = 1 << 30


def attention_plain(q, k, v, window, q_offset):
    """The plain version of flash_attention on (B, H, S, hd) inputs:
    ``ref.attention_ref``, or, where its dense scores would pass
    ``DENSE_SCORES_MAX``, the same function computed 1024 x 1024 tiles at
    a time by ``models.attention.chunked_causal_attention``."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import chunked_causal_attention
    Bs, Hq, Sq, _ = q.shape
    if Bs * Hq * Sq * k.shape[2] <= DENSE_SCORES_MAX:
        return ref.attention_ref(q, k, v, window=window, q_offset=q_offset)
    return chunked_causal_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=window, q_offset=q_offset).transpose(1, 2)


def attention_timing(Sq, Skv) -> dict:
    """``time_ms``'s iterations for a flash_attention shape, fewer as the
    scores grow (the 32k prefill's plain version takes about 1 s a call);
    {} keeps the caller's default."""
    if Sq * Skv > 1 << 28:
        return {"iters": 1, "reps": 2}
    if Sq * Skv > 1 << 20:
        return {"iters": 5, "reps": 3}
    return {}


def attention_library(q, k, v, window, q_offset):
    """One SDPA call computing flash_attention's function: ``is_causal``
    where the mask is the plain causal square (no S x S mask), else the
    ``attn_mask`` tensor."""
    import torch.nn.functional as F
    Sq, Skv = q.shape[2], k.shape[2]
    if window is None and q_offset == 0 and Sq == Skv:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    mask = attn_mask(Sq, Skv, window, q_offset, q.device)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def attention_case(spec, seed: int = 9, device: DeviceLike = None):
    """q, k, v of flash_attention at ``spec`` (an ``ATTN_SHAPES`` entry),
    in the model's layouts: (B, S, heads, hd) projections as views."""
    Bs, Hq, KVh, Sq, Skv, hd = spec[:6]
    dtype, dev = getattr(torch, spec[8]), resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((Bs, S, n, hd), generator=gen, device=dev,
                             dtype=torch.float32).to(dtype).transpose(1, 2)
                 for S, n in ((Sq, Hq), (Skv, KVh), (Skv, KVh)))


def flash_decode_case(spec, seed: int = 10, device: DeviceLike = None):
    """q, K and V caches and per-lane lengths of flash_decode at ``spec``
    (a ``DECODE_SHAPES`` entry)."""
    Bs, Hq, KVh, W_, hd, lens, dt = spec
    dtype, dev = getattr(torch, dt), resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((Bs, Hq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((Bs, KVh, W_, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((Bs, KVh, W_, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def _measure(kernel: Callable, plain: Callable, library, dev, kw=None):
    """(kernel ms, plain ms, library ms or None) on ``dev``; ``kw`` are
    ``time_ms``'s iterations (default 20 x 3)."""
    if dev.type == "cuda":
        kw = kw or {"iters": 20, "reps": 3}
        return (time_ms(kernel, **kw), time_ms(plain, **kw),
                None if library is None else time_ms(library, **kw))
    plain_ms = wall_ms(plain)
    return (plain_ms, plain_ms,
            None if library is None else wall_ms(library))


def _paged_rows(shapes: Dict[str, tuple], dtypes, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    for name, spec in shapes.items():
        Bs, Hs, KVs, hd, ps, Ps, Ws, lens_t = spec
        for dt in dtypes:
            q, kp, vp, tables, lens = paged_decode_case(
                spec, getattr(torch, dt), device=dev)

            def plain():
                return ref.paged_decode_ref(q, kp, vp, tables, lens)

            kernel = (plain if dev.type == "cpu" else
                      lambda: decode_attention.paged_flash_decode(
                          q, kp, vp, tables, lens))
            live = lens > 0       # an idle lane: the kernel gives zeros
            err = _err(kernel()[live], plain()[live])
            sq, sk, sv, mask = sdpa_paged_inputs(q, kp, vp, tables, lens)
            ms, plain_ms, lib_ms = _measure(
                kernel, plain, lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask, enable_gqa=True), dev)
            size = q.element_size()
            ctx = int(sum(min(int(n), Ws * ps) for n in lens_t))
            nbytes = (2 * q.numel() * size + 2 * ctx * KVs * hd * size
                      + tables.numel() * 4 + lens.numel() * 4)
            yield ("paged_flash_decode", name, dt, err, ms, plain_ms,
                   lib_ms, bound(nbytes, 4 * ctx * Hs * hd, dt),
                   f"page_size={ps};pool_pages={Ps}")


def _attention_rows(shapes: Dict[str, tuple], dev):
    from repro_torch.kernels import flash_attention
    for name, spec in shapes.items():
        Bs, Hq, KVh, Sq, Skv, hd, win, off, dt = spec
        q, k, v = attention_case(spec, device=dev)

        def plain():
            return attention_plain(q, k, v, win, off)

        kernel = (plain if dev.type == "cpu" else
                  lambda: flash_attention.flash_attention(
                      q, k, v, window=win, q_offset=off))
        err = _err(kernel(), plain())
        ms, plain_ms, lib_ms = _measure(
            kernel, plain, attention_library(q, k, v, win, off), dev,
            attention_timing(Sq, Skv))
        pairs = attn_pairs(Sq, Skv, win, off)
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        yield ("flash_attention", name, dt, err, ms, plain_ms, lib_ms,
               attention_bound(nbytes, 4 * Bs * Hq * hd * pairs, dt),
               f"causal_gflop={4 * Bs * Hq * hd * pairs / 1e9:.3f}")


def _decode_rows(shapes: Dict[str, tuple], dev):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    for name, spec in shapes.items():
        Bs, Hq, KVh, W_, hd, lens, dt = spec
        q, k, v, lengths = flash_decode_case(spec, device=dev)

        def plain():
            return ref.decode_ref(q, k, v, lengths)

        kernel = (plain if dev.type == "cpu" else
                  lambda: decode_attention.flash_decode(q, k, v, lengths))
        err = _err(kernel(), plain())
        mask = (torch.arange(W_, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sq = q[:, :, None, :]
        ms, plain_ms, lib_ms = _measure(
            kernel, plain, lambda: F.scaled_dot_product_attention(
                sq, k, v, attn_mask=mask, enable_gqa=True), dev)
        ctx = sum(min(n, W_) for n in lens)
        size = q.element_size()
        nbytes = 2 * q.numel() * size + 2 * ctx * KVh * hd * size + 4 * Bs
        yield ("flash_decode", name, dt, err, ms, plain_ms, lib_ms,
               bound(nbytes, 4 * ctx * Hq * hd, dt),
               f"cache_mb={2 * k.numel() * size / 1e6:.1f}")


def _ladn_rows(shapes: Dict[str, tuple], dev):
    from repro_torch.core.diffusion import DiffusionSchedule
    from repro_torch.kernels import ladn_denoise, ref
    for name, spec in shapes.items():
        args = ladn_case(*spec, device=dev)
        plain_args = args[:-1] + (DiffusionSchedule(
            *(torch.as_tensor(a, device=dev) for a in args[-1])),)

        def plain():
            return ref.ladn_denoise_ref(*plain_args)

        kernel = (plain if dev.type == "cpu" else
                  lambda: ladn_denoise.ladn_denoise_fused(*args))
        err = _err(kernel(), plain())
        ms, plain_ms, _ = _measure(kernel, plain, None, dev)
        G, T, I = spec[:3]  # noqa: E741
        yield ("ladn_denoise", name, "float32", err, ms, plain_ms, None,
               ladn_bound(*spec), f"G={G};T={T};I={I}")


def bench_kernels(device: DeviceLike = None
                  ) -> Tuple[List[str], List[dict]]:
    """Every kernel at the reference's bench shapes and, on the card, at
    the main path's (on the CPU both columns would be the plain version);
    returns (csv rows, records).  A record's ``ok`` says whether the
    kernel matched its plain version (bf16 2e-2, f32 1e-4)."""
    dev = resolve_device(device)
    mode = "cuda" if dev.type == "cuda" else "plain-cpu"
    gens = [_attention_rows(BENCH_ATTN, dev), _decode_rows(BENCH_DECODE, dev),
            _paged_rows(BENCH_PAGED, ("float32",), dev),
            _ladn_rows(BENCH_LADN, dev)]
    if dev.type == "cuda":
        gens += [_paged_rows(PAGED_SHAPES, ("bfloat16", "float32"), dev),
                 _ladn_rows({**LADN_SHAPES, **LADN_WIDE}, dev),
                 _attention_rows(ATTN_SHAPES, dev),
                 _decode_rows(DECODE_SHAPES, dev)]
    rows, records = [], []
    for gen in gens:
        for kern, shape, dt, err, ms, plain_ms, lib_ms, (bms, by), extra \
                in gen:
            tol = LADN_TOL if kern == "ladn_denoise" else TOL[dt]
            name = f"kernel_{kern}/{shape}/{dt}"
            lib = "" if lib_ms is None else f"sdpa_us={lib_ms * 1e3:.1f};"
            rows.append(f"{name},{ms * 1e3:.1f},{extra};"
                        f"plain_us={plain_ms * 1e3:.1f};{lib}"
                        f"bound_us={bms * 1e3:.3f};err={err:.2e};"
                        f"mode={mode}")
            records.append({"bench": name, "kernel": kern, "shape": shape,
                            "dtype": dt, "mode": mode, "us_per_call":
                            ms * 1e3, "plain_us": plain_ms * 1e3,
                            "library_us": (None if lib_ms is None
                                           else lib_ms * 1e3),
                            "bound_us": bms * 1e3, "bound_by": by,
                            "max_abs_err": err, "tol": tol,
                            "ok": bool(err <= tol)})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows, records

