"""Helpers for the flash-attention tile tests: a plain PyTorch mirror of
the tensor-core kernels' arithmetic (``csrc/flash_attention.cu``: bf16,
and f32 through 3xTF32), the kernels' per-warp tile rules written out in
Python, and a check that a tile plan covers the mask.  PyTorch only, so
that the ``cuda`` tests that use it also collect on a machine without
JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it (to
    nearest, ties away from zero) with the 13 bits below cleared: add half
    the dropped range to the bit pattern and clear it."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3xTF32's operand split: x = hi + lo + O(2^-22 |x|), both tf32."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_product(a: torch.Tensor, b: torch.Tensor,
                 three: bool = True) -> torch.Tensor:
    """a @ b as the f32 kernel forms it on the tensor cores: hi * hi,
    plus the cross terms hi * lo + lo * hi summed apart (``three``);
    without them, one TF32 product."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if not three:
        return ah @ bh
    return ah @ bh + (ah @ bl + al @ bh)


def allowed(qpos: int, key: int, Skv: int, causal: bool,
            window: Optional[int]) -> bool:
    """Whether the query at position ``qpos`` attends ``key``."""
    return (key < Skv and (not causal or key <= qpos)
            and (window is None or key > qpos - window))


def block_keys(plan, block: int, H: int, KV: int, Sq: int, Skv: int,
               window: Optional[int] = None, q_offset: int = 0,
               causal: bool = True) -> Tuple[range, range]:
    """What block ``block`` of ``plan``'s grid computes, as the kernel
    (``csrc/flash_attention.cu``) decides it: the packed rows it holds
    within its (batch, KV head), and the key tiles it loads, in order."""
    G = H // KV
    ntq = -(-(Sq * G) // plan.rows)
    t = ntq - 1 - block % ntq                      # latest first
    rows = range(t * plan.rows, min(t * plan.rows + plan.rows, Sq * G))
    first, last = rows[0] // G, rows[-1] // G
    kmin = max(0, q_offset + first - window + 1) if window else 0
    kmax = min(Skv - 1, q_offset + last) if causal else Skv - 1
    if kmax < kmin:
        return rows, range(0)
    return rows, range(kmin // plan.bk, kmax // plan.bk + 1)


def warp_tile_flags(k0: int, bk: int, wlo: int, whi: int, Skv: int,
                    causal: bool, window: Optional[int]):
    """The kernel's (skip, edge) for a warp whose live rows sit at query
    positions [wlo, whi] and the key tile [k0, k0 + bk): skip the tile
    outright, or mask it element by element."""
    win = window or 0
    skip = (causal and k0 > whi) or (win > 0 and k0 + bk - 1 <= wlo - win)
    edge = (k0 + bk > Skv or (causal and k0 + bk - 1 > wlo)
            or (win > 0 and k0 <= whi - win))
    return skip, edge


def check_plan_covers_mask(fa, plan, B, H, KV, Sq, Skv, window=None,
                           q_offset=0, causal=True) -> int:
    """``plan``'s blocks' rows cover the ``Sq * G`` packed rows of every
    (batch, KV head) once, the key tiles a block loads cover every
    (row, key) pair the mask allows exactly once, no tile it loads lies
    wholly outside the mask, and each warp's skip / edge rule drops only
    pairs the mask refuses.  A warp of row group g and key slice
    s takes keys [s * w, s * w + w) of each tile, w = bk // split.  Returns
    the number of tiles the grid loads."""
    G = H // KV
    w = plan.bk // plan.split
    per_bh = plan.blocks // (B * KV)
    assert per_bh * B * KV == plan.blocks
    seen_rows = []
    loaded = 0
    for block in range(per_bh):
        rows, tiles = block_keys(plan, block, H, KV, Sq, Skv, window,
                                    q_offset, causal)
        seen_rows.extend(rows)
        assert list(tiles) == sorted(set(tiles))       # each tile once
        loaded += len(tiles)
        keys = {t * plan.bk + j for t in tiles for j in range(plan.bk)}
        for t in tiles:                                 # none wholly out
            assert any(allowed(q_offset + r // G, key, Skv, causal, window)
                       for r in rows
                       for key in range(t * plan.bk, t * plan.bk + plan.bk))
        for r in rows:
            want = {j for j in range(Skv)
                    if allowed(q_offset + r // G, j, Skv, causal, window)}
            assert want <= keys, (block, r)
        for w0 in range(rows[0], rows[-1] + 1, 16):
            wrows = range(w0, min(w0 + 16, rows[-1] + 1))
            wlo = q_offset + wrows[0] // G
            whi = q_offset + wrows[-1] // G
            for k0 in (t * plan.bk + s * w for t in tiles
                       for s in range(plan.split)):
                skip, edge = warp_tile_flags(k0, w, wlo, whi, Skv, causal,
                                             window)
                ok = [allowed(q_offset + r // G, key, Skv, causal, window)
                      for r in wrows for key in range(k0, k0 + w)]
                assert not (skip and any(ok)), (w0, k0)
                assert edge or all(ok), (w0, k0)
    assert sorted(seen_rows) == list(range(Sq * G))
    return loaded * B * KV


def mirror_flash_attention(fa, q, k, v, *, causal=True, window=None,
                           q_offset=0, split_p=True, round_out=True,
                           plan=None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, on the CPU.

    q (B,H,Sq,hd), k, v (B,KV,Skv,hd) in bf16 or f32; ``plan`` (default:
    the tile plan) fixes the blocks.  Block by block, for each key slice of
    the plan's split (its keys of every tile, tiles in the plan's order):
    f32 scores in log2 units, masked to -inf; online max / denominator /
    rescale in f32 with a row that has seen no valid key kept at p = 0;
    P V with f32 accumulation.  bf16: the scores of the bf16 inputs; each
    probability rounded to bf16 (hi) and, with ``split_p``, its remainder
    too (lo), both multiplied into V.  f32 (3xTF32): Q K^T and P V each as
    :func:`tf32_product`, with ``split_p`` its three products, without
    it one.  The slices then merge: slice s's output times exp2(m_s - M) /
    L, M the largest m_s and L = sum_s exp2(m_s - M) l_s, summed in slice
    order (zeros where no key was valid), rounded to q's dtype; with
    ``round_out=False`` the f32 output before that last rounding."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    f32 = q.dtype == torch.float32
    if plan is None:
        plan = fa.tile_plan(B, H, KV, Sq, Skv, hd, q.dtype, window,
                            q_offset, causal)
    bk = plan.bk
    w = bk // plan.split
    sl2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    pad = -(-Skv // bk) * bk - Skv + bk
    kf = torch.cat([k.float(), k.new_zeros(B, KV, pad, hd).float()], 2)
    vf = torch.cat([v.float(), v.new_zeros(B, KV, pad, hd).float()], 2)
    out = torch.zeros(B, KV, Sq * G, hd)
    ninf = torch.tensor(float("-inf"))
    for b in range(B):
        for h in range(KV):
            # packed row R = position * G + head
            qp = q[b, h * G:(h + 1) * G].float().transpose(0, 1)
            qp = qp.reshape(Sq * G, hd)
            for block in range(plan.blocks // (B * KV)):
                rows, tiles = block_keys(plan, block, H, KV, Sq, Skv,
                                            window, q_offset, causal)
                R = torch.tensor(list(rows))
                qpos = (q_offset + R // G)[:, None]
                parts = []
                for sl in range(plan.split):
                    m = torch.full((len(R),), float("-inf"))
                    l = torch.zeros(len(R))  # noqa: E741
                    o = torch.zeros(len(R), hd)
                    for t in tiles:
                        k0 = t * bk + sl * w
                        keys = torch.arange(k0, k0 + w)[None]
                        kt = kf[b, h, k0:k0 + w].T
                        s = (tf32_product(qp[R], kt, split_p) if f32
                             else qp[R] @ kt) * sl2
                        ok = keys < Skv
                        if causal:
                            ok = ok & (keys <= qpos)
                        if window is not None:
                            ok = ok & (keys > qpos - window)
                        s = torch.where(ok, s, ninf)
                        mx = torch.maximum(m, s.amax(1))
                        base = torch.where(mx == ninf, torch.zeros(()), mx)
                        alpha = torch.exp2(m - base)
                        m = mx
                        p = torch.exp2(s - base[:, None])
                        l = l * alpha + p.sum(1)  # noqa: E741
                        vt = vf[b, h, k0:k0 + w]
                        o = o * alpha[:, None]
                        if f32:
                            o = o + tf32_product(p, vt, split_p)
                            continue
                        hi = p.to(torch.bfloat16).float()
                        o = o + hi @ vt
                        if split_p:
                            o = o + (p - hi).to(torch.bfloat16).float() @ vt
                    parts.append((m, l, o))
                M = torch.stack([m for m, _, _ in parts]).amax(0)
                Mb = torch.where(M == ninf, torch.zeros(()), M)
                L = torch.zeros(len(R))
                for m, l, _ in parts:
                    L = L + torch.exp2(m - Mb) * l
                acc = torch.zeros(len(R), hd)
                for m, _, o in parts:
                    f = torch.where(L > 0, torch.exp2(m - Mb) / L,
                                    torch.zeros(()))
                    acc = acc + o * f[:, None]
                out[b, h, R] = acc
    out = out.reshape(B, KV, Sq, G, hd).transpose(2, 3)
    out = out.reshape(B, H, Sq, hd)
    return out.to(q.dtype) if round_out else out
