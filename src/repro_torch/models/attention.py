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
    through ``ops.flash_attention`` with a query offset and the layer's
    window, and ``ops.paged_flash_decode`` (full layers) or
    ``ops.paged_flash_decode_window`` (windowed layers).  The pool keeps
    every position of every layer; a windowed layer reads only the last
    ``window`` of them.

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

On a mesh whose "model" ranks cut the query heads between heads, the
full-sequence paths are head-parallel, as the reference keeps its
"heads" on "model": each rank attends only its own H / M query heads
against the K/V heads they read, and ``wo`` is row-parallel
(``_own_heads``).  The decode paths attend every head on every rank,
as the reference does: a dense ring cut over its positions, or a page
pool cut into page blocks over the data ranks, needs every head's query
on each rank.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import sharding
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


def _heads_tp(cfg) -> Tuple[bool, bool]:
    """(query heads, K/V heads) computed tensor-parallel on "model" in
    the current context: a projection's "model" cut falls between heads.
    A cut that falls mid-head (``H * hd`` divisible, ``H`` not) is
    gathered instead, and outside a context nothing is parallel."""
    M = sharding.model_size()
    d, hd = cfg.d_model, cfg.head_dim
    heads = (sharding.splits("wq", (d, cfg.num_heads * hd))
             and cfg.num_heads % M == 0)
    kv = (heads and sharding.splits("wk", (d, cfg.num_kv_heads * hd))
          and cfg.num_kv_heads % M == 0)
    return heads, kv


def _own_heads(cfg) -> Optional[Tuple[int, int, int, int]]:
    """(first query head, query heads, first K/V head, K/V heads) that
    this rank attends when its "model" rank keeps its query heads
    (head-parallel attention): rank j's H / M heads from j H / M, and
    the K/V heads they read.  Where M divides KV that is the rank's own
    column block of ``wk`` / ``wv``; where one K/V head serves several
    ranks (the rank's heads inside one group of G = H / KV) it is that
    one head.  None where the query heads are not cut between heads
    (``_heads_tp``), and where a rank's heads would straddle two K/V
    groups: those ranks attend every head (the gathered path)."""
    if not _heads_tp(cfg)[0]:
        return None
    mesh = sharding.current().mesh
    nq = cfg.num_heads // mesh.shape["model"]
    G = cfg.num_heads // cfg.num_kv_heads
    q0 = mesh.local_rank("model") * nq
    if nq % G == 0:
        return q0, nq, q0 // G, nq // G
    if G % nq == 0:
        return q0, nq, q0 // G, 1
    return None


def _project(p, cfg, x, own=None, kv_whole: bool = True):
    """The q, k, v projections and biases.  Outside a mesh, or with
    ``own`` None, every head: a column-parallel projection's heads are
    all-gathered over "model" after the product (its backward a
    reduce-scatter), a gathered one computes every head; FSDP's "data"
    cuts are gathered first.  With ``own`` (:func:`_own_heads`) q is
    this rank's query heads, computed on its column block of ``wq`` with
    no gather, and k / v the K/V heads they read (its column block where
    M divides KV, else the gathered weight's columns of that head),
    or every K/V head with ``kv_whole`` (a cache or a page pool keeps
    them all).  When the heads are split the attention's "model" ranks
    hold partial cotangents, so the replicated input and biases enter
    with a backward that sums over "model"."""
    ctx = sharding.current()
    mesh = ctx.mesh if ctx is not None else None
    d, hd = cfg.d_model, cfg.head_dim
    heads, kv = _heads_tp(cfg)
    if heads:
        x = sharding.enter(x, mesh, ("model",))

    def proj(name, bname, width, tp, gather=True, cols=None):
        """x times ``name``: its column block where ``tp`` (all-gathered
        over "model" after the product when ``gather``), else the whole
        weight, or its columns ``cols``; plus the bias, cut alike."""
        w = sharding.weight(p[name], name, (d, width),
                            keep=("model",) if tp else (), partial=heads)
        if cols is not None:
            w = w[:, cols]
        y = x @ w
        if tp and gather:
            y = sharding.all_gather(y, mesh, "model", -1)
        if bname not in p:
            return y
        b = sharding.enter(p[bname], mesh, ("model",)) if heads else p[bname]
        if tp and not gather:
            c = width // mesh.shape["model"]
            cols = slice(mesh.local_rank("model") * c,
                         (mesh.local_rank("model") + 1) * c)
        return y + (b if cols is None else b[cols])

    H, KV = cfg.num_heads, cfg.num_kv_heads
    if own is None:
        return (proj("wq", "bq", H * hd, heads),
                proj("wk", "bk", KV * hd, kv),
                proj("wv", "bv", KV * hd, kv))
    q = proj("wq", "bq", H * hd, True, gather=False)
    if kv_whole:
        k, v = proj("wk", "bk", KV * hd, kv), proj("wv", "bv", KV * hd, kv)
    elif kv:
        k = proj("wk", "bk", KV * hd, True, gather=False)
        v = proj("wv", "bv", KV * hd, True, gather=False)
    else:
        cols = slice(own[2] * hd, (own[2] + own[3]) * hd)
        k = proj("wk", "bk", KV * hd, False, cols=cols)
        v = proj("wv", "bv", KV * hd, False, cols=cols)
    return q, k, v


def _out(p, cfg, o: torch.Tensor) -> torch.Tensor:
    """The output projection of the attention heads ``o`` (..., width):
    every head (H * hd), or this rank's own heads under head-parallel
    attention.  On a mesh whose "model" ranks split the heads, each rank
    multiplies its heads' part of ``o`` by its rows of ``wo``
    (row-parallel) and the partial products are summed over "model";
    otherwise ``wo`` whole."""
    width, d = cfg.num_heads * cfg.head_dim, cfg.d_model
    heads, _ = _heads_tp(cfg)
    if not heads:
        return o @ sharding.weight(p["wo"], "wo", (width, d))
    mesh = sharding.current().mesh
    c = width // mesh.shape["model"]
    if o.shape[-1] != c:                   # every head: keep this rank's
        j = mesh.local_rank("model")
        o = o[..., j * c:(j + 1) * c]
    y = o @ sharding.weight(p["wo"], "wo", (width, d), keep=("model",),
                            partial=True)
    return sharding.reduce(y, mesh, ("model",))


def _project_qkv(p, cfg, blk, x, positions, own=None,
                 kv_whole: bool = True):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,KVk,hd), with the block's
    RoPE applied (its ``rope``, else the config's ``rope_theta``): every
    head (``own`` None), or this rank's query heads and their K/V heads
    (every K/V head with ``kv_whole``); see ``_project``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = _project(p, cfg, x, own, kv_whole)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if blk.use_rope:
        rope = getattr(blk, "rope", None)
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _attn_heads(cfg):
    """:func:`_own_heads` for a full-sequence attention (train, prefill,
    a paged chunk), its layout recorded in the context's report:
    ``heads`` is ``model=tp`` where this rank attends its own query
    heads, ``model=gathered`` where every rank attends every head."""
    own = _own_heads(cfg)
    if sharding.current() is not None:
        sharding.note("heads", "model=gathered" if own is None
                      else "model=tp")
    return own


def _kv_of(own, k, v):
    """k, v (B,S,KV,hd) narrowed to the K/V heads of ``own``."""
    if own is None or k.shape[2] == own[3]:
        return k, v
    return (k.narrow(2, own[2], own[3]), v.narrow(2, own[2], own[3]))


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


def _attend_heads(q, k, v, window, q_offset=0):
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd) -> (B,Sq,H,hd) through the
    kernel wrapper, which takes the heads-first layout as views: its
    differentiable form, which is the kernel call itself unless a
    gradient is taken."""
    return kernel_ops.flash_attention_grad(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=q_offset).transpose(1, 2)


def _attend(q, k, v, window, q_offset=0):
    """:func:`_attend_heads` with the heads flattened: (B,Sq,H*hd)."""
    B, Sq, H, hd = q.shape
    return _attend_heads(q, k, v, window, q_offset).reshape(B, Sq, H * hd)


def attend_train(p, cfg, blk, x, positions) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill forward); on a
    mesh each rank attends its own query heads where they divide
    "model" (``_own_heads``)."""
    own = _attn_heads(cfg)
    q, k, v = _project_qkv(p, cfg, blk, x, positions, own, kv_whole=False)
    return _out(p, cfg, _attend(q, k, v, blk.window))


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
    own = _attn_heads(cfg)
    q, k, v = _project_qkv(p, cfg, blk, x, positions, own)
    out = _out(p, cfg, _attend(q, *_kv_of(own, k, v), blk.window))
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


def _ring(cfg, blk, cache, max_len: Optional[int]) -> Tuple[int, int, bool]:
    """(W, this rank's first ring slot, cut) of a dense cache: its global
    ring size, and whether a mesh's "model" ranks cut it along its
    positions (``launch.sharding.pool_pspecs``: where "model" divides W,
    a one-rank axis included), each holding W / M slots from the
    offset."""
    Wl = cache["k"].shape[2]
    ctx = sharding.current()
    if ctx is None:
        return Wl, 0, False
    M = ctx.mesh.shape.get("model", 1)
    if M == 1:
        return Wl, 0, "model" in ctx.mesh.shape
    if max_len is None:
        raise ValueError("a decode on a mesh of more than one 'model' rank "
                         "needs max_len to size the ring")
    W = min(blk.window or max_len, max_len)
    cut = W % M == 0
    if Wl != (W // M if cut else W):
        raise ValueError(f"ring of {Wl} slots on this rank; a {W}-slot ring "
                         f"over {M} 'model' ranks is {W // M if cut else W}")
    return W, ctx.mesh.local_rank("model") * Wl if cut else 0, cut


def decode(p, cfg, blk, x, cache, max_len: Optional[int] = None
           ) -> Tuple[torch.Tensor, dict]:
    """One-token decode per slot.  x (B,1,d); ``cache["pos"]`` (B,) holds
    each slot's tokens written so far.

    Writes the new K/V at ring slot pos % W in place, then attends through
    ``ops.flash_decode`` (the CUDA kernel on the card) over
    min(pos + 1, W) slots: the reference's validity rule, slot j valid iff
    j <= pos or pos >= W.  An int8 cache writes the quantised K/V and
    their scales, dequantises the whole ring to f32 and attends with
    ``q`` in f32: the reference's f32 read.

    On a mesh whose "model" ranks cut the ring along its positions (W /
    M slots each, W from ``max_len`` as ``init_kv_cache`` sizes it), the
    new K/V go only to the rank holding slot pos % W; since the valid
    slots are a prefix, rank j's are the first clamp(min(pos + 1, W) -
    j W / M, 0, W / M) of its own.  Each rank runs the split pass alone
    over them (``ops.flash_decode_partials``), the f32 partials are
    all-gathered over "model", and the merge pass alone
    (``ops.decode_merge``) combines all of them, for every head on every
    rank.  A ring "model" does not divide is whole on every rank and
    takes ``ops.flash_decode``."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos = cache["pos"]
    q, k, v = _project_qkv(p, cfg, blk, x, pos[:, None])
    W, first, cut = _ring(cfg, blk, cache, max_len)
    Wl = cache["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    slot = (pos % W).long() - first
    mine = ((slot >= 0) & (slot < Wl))[:, None, None]
    slot = torch.clamp(slot, 0, Wl - 1)
    new = dict(cache, pos=pos + 1)
    q = q[:, 0].contiguous()

    def write(name, t):
        ring = cache[name]
        t = t.to(ring.dtype)
        ring[rows, :, slot] = (torch.where(mine, t, ring[rows, :, slot])
                               if cut else t)

    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            vals, scale = _quantize_kv(t[:, 0])    # (B,KV,hd), (B,KV,1)
            write(name, vals)
            write(name + "_scale", scale)
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], torch.float32)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], torch.float32)
        q = q.float()
    else:
        write("k", k[:, 0])
        write("v", v[:, 0])
        k_read, v_read = cache["k"], cache["v"]
    if cut:
        out = _cut_ring_decode(q, k_read, v_read, pos, W, first)
    else:
        if sharding.current() is not None:
            sharding.note("kv_ring", "whole")
        length = torch.clamp(pos + 1, max=W).to(torch.int32)
        out = kernel_ops.flash_decode(q, k_read, v_read, length)
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return _out(p, cfg, out), new


def _cut_ring_decode(q, k_read, v_read, pos, W: int, first: int):
    """Decode against this rank's ring slots [first, first + W / M) of a
    W-slot ring cut over "model": the split pass over the valid prefix of
    them, the partials all-gathered over "model", the merge pass over
    every rank's."""
    Wl = k_read.shape[2]
    length = torch.clamp(torch.clamp(pos + 1, max=W) - first, 0,
                         Wl).to(torch.int32)
    acc, m, l = kernel_ops.flash_decode_partials(q, k_read, v_read, length)
    mesh = sharding.current().mesh
    acc, m, l = (sharding.all_gather(t, mesh, "model", 2)
                 for t in (acc, m, l))
    sharding.note("kv_ring", "model=split")
    return kernel_ops.decode_merge(acc, m, l, q.dtype)


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
    """Empty per-layer page pool, full or windowed attention alike: a
    windowed layer keeps every position too and reads its window."""
    if cfg.kv_cache_dtype == "int8":
        raise ValueError(
            "paged KV serving keeps the model dtype; an int8 KV cache "
            f"(kv_cache_dtype={cfg.kv_cache_dtype}) takes the dense slots")
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


def _pages(cache, num_pages: Optional[int]) -> Optional[Tuple[int, int]]:
    """(first page, pages) of this rank's block of a page pool its mesh's
    data ranks cut (``launch.sharding.page_block``, a one-rank data axis
    included); None outside a mesh and for a pool kept whole on every
    rank.  ``num_pages`` is the whole pool's size (on a mesh of one data
    rank the pool held here).  Records the layout as ``kv_pages``."""
    ctx = sharding.current()
    if ctx is None:
        return None
    held = cache["k_pages"].shape[0]
    if num_pages is None:
        if sharding.axes_size(ctx.mesh, sharding.data_axes(ctx.mesh)) > 1:
            raise ValueError("a paged step on a mesh of more than one data "
                             "rank needs num_pages to place the pool")
        num_pages = held
    block = sharding.page_block(ctx.mesh, num_pages)
    if held != (num_pages if block is None else block[1]):
        raise ValueError(f"{held} pages on this rank; a pool of {num_pages} "
                         f"pages on this mesh holds "
                         f"{num_pages if block is None else block[1]}")
    sharding.note("kv_pages", "whole" if block is None else "data=split")
    return block


def _put_owned(pool: torch.Tensor, page: torch.Tensor, slot: torch.Tensor,
               vals: torch.Tensor, lo: int) -> None:
    """``pool[page - lo, :, slot] = vals`` for the rows whose global page
    lies in this rank's block [lo, lo + Pl) of the pool; pool (Pl, KV, ps,
    hd), page and slot (n,), vals (n, KV, hd).  In place and without a
    host sync: a row this rank does not own repeats the first owned row's
    write (where it owns none, the first row's place is written with its
    own value), so rows that meet at one place write one value."""
    Pl = pool.shape[0]
    local = page.long() - lo
    mine = (local >= 0) & (local < Pl)
    local = torch.clamp(local, 0, Pl - 1)
    slot = slot.long()
    vals = torch.where(mine[:, None, None], vals.to(pool.dtype),
                       pool[local, :, slot])
    j = torch.argmax(mine.to(torch.int32))
    pool[torch.where(mine, local, local[j]), :,
         torch.where(mine, slot, slot[j])] = torch.where(
             mine[:, None, None], vals, vals[j])


def _gather_owned(pages: torch.Tensor, block_table: torch.Tensor,
                  max_ctx: int, lo: int) -> torch.Tensor:
    """:func:`_gather_pages` over this rank's block [lo, lo + Pl) of the
    pool: (max_ctx, KV, hd), zeros at the positions whose page another
    rank holds."""
    Pl, _, ps, _ = pages.shape
    pos = torch.arange(max_ctx, device=pages.device)
    local = _page_of(block_table, pos, ps) - lo
    mine = ((local >= 0) & (local < Pl))[:, None, None]
    got = pages[torch.clamp(local, 0, Pl - 1), :, pos % ps]
    return torch.where(mine, got, torch.zeros_like(got))


def paged_chunk_inputs(p, cfg, blk, x, cache, block_table, start,
                       num_pages: Optional[int] = None):
    """One prompt chunk's attention up to its kernel: the chunk's K/V
    written into the pool, and the kernel's inputs, the queries q
    (1, C, Hq, hd) and the gathered context kd, vd (1, W * ps, KVk, hd).
    x (1, C, d) holds tokens at absolute positions start..start+C-1 (the
    tail may be padding); ``start`` is an int or a 0-d integer tensor on
    the pool's device (a captured graph reads it there).

    On a mesh whose data ranks cut the pool into page blocks
    (``num_pages`` the whole pool's size; :func:`_pages`), each rank
    writes the chunk's positions whose pages it holds, gathers the
    context's positions it holds with zeros elsewhere (the K/V heads it
    attends), and the gathers are summed over the data axes: each
    position has one owner, so the sum is exact."""
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)[None]   # (1, C)
    own = _attn_heads(cfg)
    q, k, v = _project_qkv(p, cfg, blk, x, positions, own)
    block = _pages(cache, num_pages)
    ps = cache["k_pages"].shape[2]
    max_ctx = block_table.shape[-1] * ps
    if block is None:
        k_pages = _scatter_pages(cache["k_pages"], k[0], block_table, start)
        v_pages = _scatter_pages(cache["v_pages"], v[0], block_table, start)
        kd = _gather_pages(k_pages, block_table, max_ctx)[None]
        vd = _gather_pages(v_pages, block_table, max_ctx)[None]
        kd, vd = _kv_of(own, kd, vd)                 # (1, ctx, KV, hd)
    else:
        pos = positions[0]
        page = _page_of(block_table, pos, ps)
        _put_owned(cache["k_pages"], page, pos % ps, k[0], block[0])
        _put_owned(cache["v_pages"], page, pos % ps, v[0], block[0])
        kd, vd = _kv_of(own, *(_gather_owned(cache[name], block_table,
                                             max_ctx, block[0])[None]
                               for name in ("k_pages", "v_pages")))
        mesh = sharding.current().mesh
        kv = sharding.all_reduce(torch.stack([kd, vd]), mesh,
                                 sharding.data_axes(mesh))
        kd, vd = kv[0], kv[1]
    return q, kd, vd


def paged_chunk_attend(q, kd, vd, start: int,
                       window: Optional[int] = None) -> torch.Tensor:
    """The chunk's causal attention through ``ops.flash_attention`` with
    ``q_offset=start`` under the layer's ``window`` (query p reads keys
    in (p - window, p]): (1, C, Hq, hd)."""
    return _attend_heads(q, kd, vd, window, q_offset=start)


def paged_chunk_out(p, cfg, o: torch.Tensor) -> torch.Tensor:
    """The output projection of the chunk's attention ``o`` (1, C, Hq,
    hd): (1, C, d)."""
    return _out(p, cfg, o.flatten(2))


def paged_prefill_chunk(p, cfg, blk, x, cache, block_table, start: int,
                        num_pages: Optional[int] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """One prompt chunk through paged attention: :func:`paged_chunk_inputs`
    writes the chunk's KV into the pool and gathers the full context, and
    the chunk's queries attend it with absolute causal masking (and the
    layer's window) through ``ops.flash_attention`` with
    ``q_offset=start``."""
    q, kd, vd = paged_chunk_inputs(p, cfg, blk, x, cache, block_table, start,
                                   num_pages)
    o = paged_chunk_attend(q, kd, vd, start, blk.window)
    return paged_chunk_out(p, cfg, o), cache


def _owned_table(block_tables: torch.Tensor, n: torch.Tensor, ps: int,
                 lo: int, Pl: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's compacted table (B, W) int32 and local lengths (B,)
    int32 for lanes holding ``n`` (B,) positions: each lane's pages among
    its first ceil(n / ps) that lie in the block [lo, lo + Pl), as local
    ids in table order (so a partial last page stays last), padded with
    page 0, and the positions they hold.  On the device, from shapes."""
    W = block_tables.shape[1]
    j = torch.arange(W, device=block_tables.device)
    local = block_tables.long() - lo
    fill = torch.clamp(n.long()[:, None] - j * ps, 0, ps)
    owned = (fill > 0) & (local >= 0) & (local < Pl)
    order = torch.argsort(torch.where(owned, j, j + W), dim=1)
    table = torch.gather(torch.clamp(local, 0, Pl - 1), 1, order)
    table = torch.where(j < owned.sum(1, keepdim=True), table, 0)
    length = torch.where(owned, fill, 0).sum(1)
    return table.to(torch.int32), length.to(torch.int32)


def _cut_pool_decode(q, cache, block_tables, n, lo: int):
    """Decode of lanes holding ``n`` positions against this rank's page
    block from ``lo``: the split pass over its compacted table, the
    partials all-gathered over the data axes, the merge pass over every
    rank's."""
    Pl, _, ps, _ = cache["k_pages"].shape
    table, length = _owned_table(block_tables, n, ps, lo, Pl)
    acc, m, l = kernel_ops.paged_flash_decode_partials(
        q, cache["k_pages"], cache["v_pages"], table, length)
    mesh = sharding.current().mesh
    for ax in sharding.data_axes(mesh):
        acc, m, l = (sharding.all_gather(t, mesh, ax, 2) for t in (acc, m, l))
    return kernel_ops.decode_merge(acc, m, l, q.dtype)


def paged_decode_query(p, cfg, blk, x, cache, block_tables, lengths,
                       num_pages: Optional[int] = None):
    """A decode round's attention up to its kernel: each lane's new K/V
    written at position lengths[b], and (q (B, H, hd), the rank's page
    block or None; see :func:`paged_decode`)."""
    q, k, v = _project_qkv(p, cfg, blk, x, lengths[:, None])
    ps = cache["k_pages"].shape[2]
    page = _page_of(block_tables, lengths[:, None], ps)[:, 0]   # (B,)
    slot = lengths.long() % ps
    q = q[:, 0].contiguous()
    block = _pages(cache, num_pages)
    if block is None:
        dtype = cache["k_pages"].dtype
        cache["k_pages"][page, :, slot] = k[:, 0].to(dtype)
        cache["v_pages"][page, :, slot] = v[:, 0].to(dtype)
    else:
        _put_owned(cache["k_pages"], page, slot, k[:, 0], block[0])
        _put_owned(cache["v_pages"], page, slot, v[:, 0], block[0])
    return q, block


def paged_decode_attend(q, cache, block_tables, n,
                        window: Optional[int] = None) -> torch.Tensor:
    """The round's attention of each lane over its first ``n`` (B,)
    positions through ``ops.paged_flash_decode``, or over the last
    ``window`` of them through ``ops.paged_flash_decode_window``:
    (B, H, hd)."""
    if window is None:
        return kernel_ops.paged_flash_decode(q, cache["k_pages"],
                                             cache["v_pages"], block_tables,
                                             n)
    return kernel_ops.paged_flash_decode_window(
        q, cache["k_pages"], cache["v_pages"], block_tables, n, window)


def paged_decode_out(p, cfg, o: torch.Tensor, dtype) -> torch.Tensor:
    """The output projection of the round's attention ``o`` (B, H, hd):
    (B, 1, d) in ``dtype``."""
    return _out(p, cfg, o.reshape(o.shape[0], 1, -1).to(dtype))


def paged_decode(p, cfg, blk, x, cache, block_tables, lengths,
                 num_pages: Optional[int] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token decode over the shared page pool.

    x (B, 1, d); block_tables (B, W) int32; lengths (B,) int32 tokens
    already written per lane.  Writes the new token's KV at position
    lengths[b] in place, then attends lengths[b]+1 tokens through
    ``ops.paged_flash_decode`` (the CUDA kernel on the card).  Inactive
    lanes pass a null table and length 0: their writes and reads hit the
    reserved null page and the engine discards their outputs.

    On a mesh whose data ranks cut the pool into page blocks
    (``num_pages`` the whole pool's size; :func:`_pages`) every lane runs
    on every rank: the new K/V go only to the rank holding the page, each
    rank runs the split pass alone (``ops.paged_flash_decode_partials``)
    over the lane's pages in its block, the f32 partials are all-gathered
    over the data axes, and the merge pass alone (``ops.decode_merge``)
    combines them.  Rank 0 holds the null page.  A windowed layer reads
    the last ``window`` positions of each lane, outside a mesh only."""
    q, block = paged_decode_query(p, cfg, blk, x, cache, block_tables,
                                  lengths, num_pages)
    if block is None:
        out = paged_decode_attend(q, cache, block_tables, lengths + 1,
                                  blk.window)
    elif blk.window is not None:
        raise ValueError(
            f"a windowed layer (window {blk.window}) decodes from a whole "
            "page pool only: a pool cut over a mesh's data ranks merges "
            "full-length partials")
    else:
        ps = cache["k_pages"].shape[2]
        n = torch.clamp(lengths + 1, max=block_tables.shape[1] * ps)
        out = _cut_pool_decode(q, cache, block_tables, n, block[0])
    return paged_decode_out(p, cfg, out, x.dtype), cache
