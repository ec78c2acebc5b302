"""GQA attention: full-causal and sliding-window prefill, dense ring-buffer
decode, and the shared page pool.

Port of ``repro/models/attention.py``.  Three execution paths share one
set of weights:

  * ``attend_train`` / ``prefill`` -- full sequence, causal (optionally
    windowed), through ``ops.flash_attention_grad`` (the CUDA kernel on
    the card, with the plain chunked attention's gradient when one is
    taken; ``kernels.ref.attention_ref`` for CPU tensors).  The reference
    computes the same function with ``chunked_causal_attention``, its
    "reference/lowering twin" of the Pallas kernel; the port keeps that
    function as the counterpart the tests compare against.
  * ``decode`` -- one token per slot against a dense cache (full-length
    or ring-buffer windowed), through ``ops.flash_decode``.
  * ``paged_prefill_chunk`` / ``paged_decode`` -- the shared page pool,
    through ``ops.flash_attention`` with a query offset and
    ``ops.paged_flash_decode``.

Dense cache layout: {"k": (B, KV, W, hd), "v": (B, KV, W, hd),
"pos": (B,) int32}, one row per slot; ``pos`` is the number of tokens
already written.  Windowed caches are ring buffers of size W written at
``pos % W``.  The reference keeps ``pos`` a scalar and vmaps slots; the
port batches them, so each slot has its own position.  With
``kv_cache_dtype="int8"`` the rings hold int8 values and the cache adds
f32 ``k_scale`` / ``v_scale`` (B, KV, W, 1), one symmetric scale per
(head, position); decode dequantises the ring to f32 and attends in f32,
as the reference does.  The page pool keeps the model dtype only.

The JAX code returns new caches and donates the old ones; the port
writes K/V caches and page pools in place and returns them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, dtype: torch.dtype,
                   device: torch.device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, cfg.num_heads * hd, dtype, device),
        "wk": dense_init(generator, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(generator, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": dense_init(generator, cfg.num_heads * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg, x, positions, use_rope):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), with RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked causal attention (online softmax, plain PyTorch)
# ---------------------------------------------------------------------------


def _pick_chunk(S: int, target: int = 1024) -> int:
    c = min(S, target)
    while S % c:
        c //= 2
    return max(c, 1)


def chunked_causal_attention(q, k, v, *, window: Optional[int] = None,
                             q_offset: int = 0, q_chunk: int = 1024,
                             kv_chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,hd); k,v (B,Skv,KV,hd) -> (B,Sq,H,hd).

    Causal within absolute positions: query i (at q_offset+i) attends keys
    j <= q_offset+i and, if windowed, j > q_offset+i - window.  Scores and
    the running softmax are f32; probabilities are rounded to the value
    dtype before the PV product, as in the reference.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = _pick_chunk(Sq, q_chunk)
    kv_chunk = _pick_chunk(Skv, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qc = q.reshape(B, Sq, KV, G, hd)
    outs = []
    for qs in range(0, Sq, q_chunk):
        qi = qc[:, qs:qs + q_chunk].float()            # (B,Cq,KV,G,hd)
        qpos = q_offset + qs + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, KV, G), NEG_INF, device=dev)
        l = torch.zeros((B, q_chunk, KV, G), device=dev)
        acc = torch.zeros((B, q_chunk, KV, G, hd), device=dev)
        for ks in range(0, Skv, kv_chunk):
            ki = k[:, ks:ks + kv_chunk]
            vi = v[:, ks:ks + kv_chunk]
            kpos = ks + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,bckd->bqkgc", qi, ki.float()) * scale
            mask = kpos[None, :] <= qpos[:, None]              # (Cq,Ckv)
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p_.to(vi.dtype).float(), vi.float())
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# block-level entry points: full sequence and dense ring-buffer decode
# ---------------------------------------------------------------------------


def _attend(q, k, v, window, q_offset=0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H*hd) through the
    kernel wrapper, which takes the heads-first layout as views: its
    differentiable form, which is the kernel call itself unless a
    gradient is taken."""
    B, Sq, H, hd = q.shape
    out = kernel_ops.flash_attention_grad(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=q_offset)
    return out.transpose(1, 2).reshape(B, Sq, H * hd)


def attend_train(p, cfg, blk, x, positions) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill forward)."""
    q, k, v = _project_qkv(p, cfg, x, positions, blk.use_rope)
    return _attend(q, k, v, blk.window) @ p["wo"]


def _cache_dtype(cfg) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return getattr(torch, cfg.dtype)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S, hd) -> (int8 values, f32 scales (..., S, 1)): symmetric
    per-(head, position) scaling, one scale per cache slot.  ``round``
    is half-to-even, as ``jnp.round``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_kv_cache(cfg, blk, batch: int, max_len: int,
                  device: torch.device) -> dict:
    """Empty dense cache: a ring of min(window, max_len) slots per row,
    plus the scales of an int8 cache."""
    W = min(blk.window or max_len, max_len)
    shape = (batch, cfg.num_kv_heads, W, cfg.head_dim)
    dtype = _cache_dtype(cfg)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.kv_cache_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                      device=device)
    return cache


def prefill(p, cfg, blk, x, positions, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Forward over the prompt; returns (out, cache).

    ``max_len`` sizes the emitted cache (>= S) so decode steps have room;
    windowed blocks emit a ring buffer of size min(window, max_len) with
    position p stored at slot p % W (matching :func:`decode`).  Attention
    reads the unquantised K/V; an int8 cache quantises the ring after."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, blk.use_rope)
    out = _attend(q, k, v, blk.window) @ p["wo"]
    kT = k.transpose(1, 2)   # (B,KV,S,hd)
    vT = v.transpose(1, 2)
    max_len = max(max_len or S, S if blk.window is None else 0)
    W = min(blk.window, max_len) if blk.window is not None else max_len
    shape = (B, cfg.num_kv_heads, W, cfg.head_dim)
    kr = torch.zeros(shape, dtype=k.dtype, device=x.device)
    vr = torch.zeros(shape, dtype=v.dtype, device=x.device)
    if W >= S:
        # position p < S <= W lands at ring slot p % W == p: right-pad
        kr[:, :, :S] = kT
        vr[:, :, :S] = vT
    else:
        # keep the last W positions, placed at their ring slots p % W
        slots = torch.arange(S - W, S, device=x.device) % W
        kr[:, :, slots] = kT[:, :, S - W:]
        vr[:, :, slots] = vT[:, :, S - W:]
    cache = {"pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    if cfg.kv_cache_dtype == "int8":
        cache["k"], cache["k_scale"] = _quantize_kv(kr)
        cache["v"], cache["v_scale"] = _quantize_kv(vr)
    else:
        cache["k"], cache["v"] = kr, vr
    return out, cache


def decode(p, cfg, blk, x, cache) -> Tuple[torch.Tensor, dict]:
    """One-token decode per slot.  x (B,1,d); ``cache["pos"]`` (B,) holds
    each slot's tokens written so far.

    Writes the new K/V at ring slot pos % W in place, then attends through
    ``ops.flash_decode`` (the CUDA kernel on the card) over
    min(pos + 1, W) slots: the reference's validity rule, slot j valid iff
    j <= pos or pos >= W.  An int8 cache writes the quantised K/V and
    their scales, dequantises the whole ring to f32 and attends with
    ``q`` in f32: the reference's f32 read."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos = cache["pos"]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None], blk.use_rope)
    W = cache["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    slot = (pos % W).long()
    new = dict(cache, pos=pos + 1)
    q = q[:, 0].contiguous()
    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            vals, scale = _quantize_kv(t[:, 0])    # (B,KV,hd), (B,KV,1)
            cache[name][rows, :, slot] = vals
            cache[name + "_scale"][rows, :, slot] = scale
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], torch.float32)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], torch.float32)
        q = q.float()
    else:
        cache["k"][rows, :, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, :, slot] = v[:, 0].to(cache["v"].dtype)
        k_read, v_read = cache["k"], cache["v"]
    length = torch.clamp(pos + 1, max=W).to(torch.int32)
    out = kernel_ops.flash_decode(q, k_read, v_read, length)
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype) @ p["wo"]
    return out, new


# ---------------------------------------------------------------------------
# paged KV cache (vLLM-style shared page pool)
# ---------------------------------------------------------------------------
#
# Layout: one pool per layer, {"k_pages": (P, KV, ps, hd), "v_pages": ...};
# page 0 is the allocator's reserved null page (never handed to a live
# sequence), so clamped/unmapped block-table entries and masked write lanes
# land there harmlessly.  The block table is shared across layers.


def init_paged_kv_cache(cfg, blk, num_pages: int, page_size: int,
                        device: torch.device) -> dict:
    """Empty per-layer page pool."""
    if blk.window is not None or cfg.kv_cache_dtype == "int8":
        raise ValueError(
            "paged KV serving supports full-attention model-dtype caches "
            f"only (window={blk.window}, kv_cache_dtype="
            f"{cfg.kv_cache_dtype})")
    dtype = getattr(torch, cfg.dtype)
    shape = (num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def _page_of(block_table: torch.Tensor, pos: torch.Tensor,
             page_size: int) -> torch.Tensor:
    """Physical page ids for logical positions; overshoot clamps onto the
    table's trailing null-padded entries (see ServeEngine row padding)."""
    idx = torch.clamp(pos // page_size, 0, block_table.shape[-1] - 1)
    return torch.gather(block_table.long(), -1, idx.long())


def _scatter_pages(pages: torch.Tensor, vals: torch.Tensor,
                   block_table: torch.Tensor, start: int) -> torch.Tensor:
    """Write ``vals`` (n, KV, hd) at positions start..start+n-1 of one
    sequence, in place.  pages (P, KV, ps, hd); block_table (W,)."""
    ps = pages.shape[2]
    pos = start + torch.arange(vals.shape[0], device=pages.device)
    page = _page_of(block_table, pos, ps)
    pages[page, :, pos % ps] = vals.to(pages.dtype)
    return pages


def _gather_pages(pages: torch.Tensor, block_table: torch.Tensor,
                  max_ctx: int) -> torch.Tensor:
    """Dense (max_ctx, KV, hd) view of one sequence's pages (garbage past
    the written length — callers mask by position)."""
    ps = pages.shape[2]
    pos = torch.arange(max_ctx, device=pages.device)
    page = _page_of(block_table, pos, ps)
    return pages[page, :, pos % ps]


def paged_prefill_chunk(p, cfg, blk, x, cache, block_table, start: int
                        ) -> Tuple[torch.Tensor, dict]:
    """One prompt chunk through paged attention.  x (1, C, d) holds tokens
    at absolute positions start..start+C-1 (the tail may be padding).

    Writes the chunk's KV into the pool, then attends the chunk's queries
    against the full gathered context with absolute causal masking, through
    ``ops.flash_attention`` with ``q_offset=start``."""
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)[None]   # (1, C)
    q, k, v = _project_qkv(p, cfg, x, positions, blk.use_rope)
    k_pages = _scatter_pages(cache["k_pages"], k[0], block_table, start)
    v_pages = _scatter_pages(cache["v_pages"], v[0], block_table, start)
    max_ctx = block_table.shape[-1] * k_pages.shape[2]
    kd = _gather_pages(k_pages, block_table, max_ctx)[None]   # (1,ctx,KV,hd)
    vd = _gather_pages(v_pages, block_table, max_ctx)[None]
    out = _attend(q, kd, vd, None, q_offset=start) @ p["wo"]
    return out, cache


def paged_decode(p, cfg, blk, x, cache, block_tables, lengths
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token decode over the shared page pool.

    x (B, 1, d); block_tables (B, W) int32; lengths (B,) int32 tokens
    already written per lane.  Writes the new token's KV at position
    lengths[b] in place, then attends lengths[b]+1 tokens through
    ``ops.paged_flash_decode`` (the CUDA kernel on the card).  Inactive
    lanes pass a null table and length 0: their writes and reads hit the
    reserved null page and the engine discards their outputs."""
    B = x.shape[0]
    hd = cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, lengths[:, None], blk.use_rope)
    ps = cache["k_pages"].shape[2]
    page = _page_of(block_tables, lengths[:, None], ps)[:, 0]   # (B,)
    slot = lengths.long() % ps
    dtype = cache["k_pages"].dtype
    cache["k_pages"][page, :, slot] = k[:, 0].to(dtype)
    cache["v_pages"][page, :, slot] = v[:, 0].to(dtype)
    out = kernel_ops.paged_flash_decode(q[:, 0].contiguous(),
                                        cache["k_pages"], cache["v_pages"],
                                        block_tables, lengths + 1)
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return out @ p["wo"], cache
